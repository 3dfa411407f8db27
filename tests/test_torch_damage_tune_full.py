"""ENCODER_TUNE=hq's full tier under the damage mask against the reference
encoder: ``H264Encoder(..., deblock=False, tune="hq")`` with
``damage_mask=True`` (the worklist's qp plane, the qp chain restarting
each compacted row at the slice qp, I16-in-P over the stack, the rate
model fed the worklist's coded qps plus the untouched rows' slice qp),
per frame with two frames in flight and in the chunk ring with the
1-frame lookahead (a drained frame seeing itself), and a masked frame
past the packer's caps coded on the host with the frame's qp plane; every
access unit byte-equal, and cv2 decodes the stream to the port's
references.  The served tier is ``test_torch_damage_tune_served.py``."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg

import conftest

cv2 = pytest.importorskip("cv2")

W, H = 64, 96                          # 4 x 6 MBs: buckets 1, 2 and 4
ROWS = H // 16
# one qp family (each qp and bucket is a compile of the reference's hq
# programs): the IDR at QP + 5 less the keyframe bias, P frames at QP
QP = 20
FULL = dict(mode="cavlc", entropy="device", deblock=False, tune="hq",
            gop=60, host_color=True, qp=QP, bitrate_kbps=450,
            damage_mask=True)
# the damaged MB rows of each P frame: buckets 1, 1, 4 (a padded copy),
# 1, 2
SCHEDULE = [(1,), (4,), (0, 2, 5), (3,), (1, 2)]


def damage_frames(schedule, seed=11, noisy=()):
    """An IDR frame, then each frame the one before with a new flat panel
    (a shade motion search cannot follow: I16-in-P territory) and a
    small moved block in each listed MB row; rows in ``noisy`` get fresh
    full-contrast noise instead (past the packer's caps)."""
    rng = np.random.default_rng(seed)
    f = conftest.make_test_frame(H, W, seed=seed)
    out = [f.copy()]
    for i, rows in enumerate(schedule, 1):
        f = f.copy()
        for r in rows:
            band = f[r * 16:r * 16 + 16]
            if r in noisy:
                band[:] = 255 * rng.integers(0, 2, band.shape[:2] + (1,),
                                             np.uint8)
                continue
            band[2:14, 8 + 4 * (i % 3):40 + 4 * (i % 3)] = (
                30 + 37 * i) % 256, 200 - 9 * i, 90 + 11 * r
            band[4:10, 48:56] = np.roll(band[4:10, 48:56], 2 * i, axis=1)
        out.append(f)
    return out


def run_pair(je, te, frames, depth=2, on_submit=None):
    """Both encoders over ``frames`` at ``depth`` in flight; asserts the
    AUs equal and returns the port's (tokens, AUs, references after each
    submit)."""
    jt, tt, toks, aus, refs = [], [], [], [], []
    for f in list(frames) + [None]:
        if f is not None:
            jt.append(je.encode_submit(f))
            tt.append(te.encode_submit(f))
            toks.append(tt[-1])
            refs.append(tuple(p.numpy().copy() for p in te._ref))
            if on_submit is not None:
                on_submit(tt[-1])
        while len(jt) >= depth or (f is None and jt):
            a, b = je.encode_collect(jt.pop(0)), te.encode_collect(tt.pop(0))
            assert a.data == b.data, f"frame {a.frame_index}"
            assert (a.frame_index, a.keyframe) == (b.frame_index, b.keyframe)
            aus.append(b.data)
    return toks, aus, refs


@pytest.fixture(scope="module")
def per_frame():
    je, te = JEnc(W, H, **FULL), TEnc(W, H, device="cpu", **FULL)
    assert (te._ktune, te._p_intra) == (je._ktune, je._p_intra) == ("hq", True)
    intra = []

    def spy(tok):
        if tok[0] == "p_masked":
            intra.append(int(tok[4][2]["mb_intra"].sum()))

    toks, aus, refs = run_pair(je, te, damage_frames(SCHEDULE), on_submit=spy)
    return {"je": je, "te": te, "toks": toks, "aus": aus, "refs": refs,
            "intra": intra}


def test_masked_full_tier_equals_the_reference(per_frame):
    """Every P frame masked over its worklist, at the P qp; the rate
    models (normalised by each frame's mean coded qp) stay equal."""
    je, te, toks = per_frame["je"], per_frame["te"], per_frame["toks"]
    assert [t[0] for t in toks] == ["intra"] + ["p_masked"] * len(SCHEDULE)
    assert [t[4][6].bucket for t in toks[1:]] == [1, 1, 4, 1, 2]
    assert {t[4][0] for t in toks[1:]} == {QP}
    assert all(t[4][2]["qp_map"].shape[0] == t[4][6].bucket
               for t in toks[1:])
    assert any(per_frame["intra"]), "no I16-in-P MB in a masked frame"
    assert je._rate._ema == te._rate._ema
    assert te._rate._ema[False] is not None


def test_masked_full_tier_decodes_to_the_references(per_frame, tmp_path):
    """cv2's luma of the stream equals the references frame for frame:
    the untouched rows' all-skip slices and the compacted rows alike."""
    path = tmp_path / "full.264"
    path.write_bytes(b"".join(per_frame["aus"]))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, ref in enumerate(per_frame["refs"]):
        ok, img = cap.read()
        assert ok, f"cv2 stopped at frame {i}"
        np.testing.assert_array_equal(np.asarray(img).reshape(H, W),
                                      ref[0][:H, :W], f"frame {i}")
    cap.release()


def test_masked_full_tier_ring_with_lookahead_equals_reference_ring():
    """An IDR, a masked chunk of four (the bucket of its most damaged
    frame, each frame's qp plane biased by the next frame's rows, the last
    by its own) and a frame drained through the per-frame masked path,
    where it sees itself as the lookahead."""
    kw = dict(FULL, superstep_chunk=4)
    je, te = JEnc(W, H, **kw), TEnc(W, H, device="cpu", **kw)
    assert te._ring_chunk == je._ring_chunk == 4
    frames = damage_frames(SCHEDULE, seed=5)
    toks, _, _ = run_pair(je, te, frames, depth=te.pipeline_depth)
    assert [t[0] for t in toks] == ["intra"] + ["ring"] * len(SCHEDULE)
    chunk, drained = toks[1][4][0], toks[-1][4][0]
    assert chunk.dmg is not None and chunk.dmg[0] == 4
    assert drained.res is None and drained.pf[0][0] == "p_masked"
    assert [k[2] for k in te._chunk_steps] == [4]
    assert je._rate._ema == te._rate._ema


def test_masked_full_tier_overflow_takes_the_frame_qp_plane(monkeypatch):
    """A damaged row of noise passes the packer's caps: the compacted
    levels and the worklist's qp plane go to the host coder as the
    frame's (the slice qp on the untouched rows), with the reference's
    bytes and rate model."""
    calls = []
    real = dmg.scatter_levels_np

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dmg, "scatter_levels_np", spy)
    je, te = JEnc(W, H, **FULL), TEnc(W, H, device="cpu", **FULL)
    noted = []
    note = te._note_qp_map

    def note_spy(qp_map, **kw):
        noted.append(qp_map)
        return note(qp_map, **kw)

    te._note_qp_map = note_spy
    frames = damage_frames([(3,), (1,)], seed=2, noisy=(3,))
    toks, _, _ = run_pair(je, te, frames)
    assert [t[0] for t in toks] == ["intra", "p_masked", "p_masked"]
    assert calls, "no masked frame overflowed"
    fq = next(q for q in noted if q is not None and q.shape[0] == ROWS)
    assert (np.delete(fq, 3, axis=0) == QP).all()
    assert je._rate._ema == te._rate._ema
    assert te.last_mv.shape[0] == ROWS
