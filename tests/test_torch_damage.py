"""Damage-driven encode in the port against the reference: the host
twin of the damage grid and the row worklist, the row-compacted P stage
(K5r and K13's plain versions inside ``row_core``), and masked access
units byte-equal to the JAX encoder's per frame and in the chunk ring
under four damage patterns, through the overflow fallback, decoded by
cv2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cavlc
from docker_nvidia_glx_desktop_tpu.ops import damage_mask as j_dmg
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device
from docker_nvidia_glx_desktop_tpu_torch.ops import damage_mask as dmg
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_inter

import conftest

cv2 = pytest.importorskip("cv2")

W, H = 128, 96       # 8 x 6 MBs: buckets 1, 2, 4 and the full frame
ROWS, COLS = H // 16, W // 16
_KW = dict(mode="cavlc", entropy="device", host_color=True)


def _damage_frames(n, pattern, h=H, w=W, seed=11):
    """Each frame is the one before with only the pattern's region
    replaced by fresh noise, so the damage grid is the pattern."""
    r = np.random.default_rng(seed)
    rows, cols = h // 16, w // 16
    f = conftest.make_test_frame(h, w, seed=seed)
    out = [f.copy()]

    def noise(hh, ww):
        return r.integers(0, 256, (hh, ww, 3)).astype(np.uint8)

    for i in range(1, n):
        f = f.copy()
        if pattern == "single-mb":
            mr, mc = i % rows, (3 * i) % cols
            f[mr * 16:(mr + 1) * 16, mc * 16:(mc + 1) * 16] = noise(16, 16)
        elif pattern == "dirty-row":
            mr = i % rows
            f[mr * 16:(mr + 1) * 16] = noise(16, w)
        elif pattern == "checkerboard":
            for mr in range(rows):
                for mc in range(cols):
                    if (mr + mc + i) % 2 == 0:
                        f[mr * 16:(mr + 1) * 16,
                          mc * 16:(mc + 1) * 16] = noise(16, 16)
        elif pattern == "full":
            f = noise(h, w)
        else:
            raise AssertionError(pattern)
        out.append(f)
    return out


def _drive(enc, frames, on_submit=None):
    depth = enc.pipeline_depth if isinstance(enc, TEnc) else getattr(
        enc, "pipeline_depth", 2)
    out, pend = [], []
    for f in frames:
        pend.append(enc.encode_submit(f))
        if on_submit is not None:
            on_submit(pend[-1])
        while len(pend) >= depth:
            out.append(enc.encode_collect(pend.pop(0)))
    while pend:
        out.append(enc.encode_collect(pend.pop(0)))
    return out


# -- the host twin and the worklist ----------------------------------------

@pytest.mark.parametrize("thr", [0, 512, 65279, 65280])
def test_damage_grid_sums_full_contrast_mbs(thr):
    """Each MB's SAD reaches 16 * 16 * 255 without wrapping."""
    r = np.random.default_rng(thr)
    prev = r.integers(0, 256, (H, W)).astype(np.uint8)
    y = prev.copy()
    y[:16, :16], prev[:16, :16] = 255, 0
    y[16:32, 32:48], prev[16:32, 32:48] = 0, 255
    y[-16:, -16:] = 255 - prev[-16:, -16:]
    g = dmg.damage_grid_np(y, prev, thr)
    np.testing.assert_array_equal(g, j_dmg.damage_grid_np(y, prev, thr))
    assert g[0, 0] == g[1, 2] == (thr < 65280)


def test_damage_grid_and_plan_equal_the_reference():
    r = np.random.default_rng(5)
    for case in range(6):
        prev = r.integers(0, 256, (H, W)).astype(np.uint8)
        y = prev.copy()
        for _ in range(case * 2):
            mr, mc = int(r.integers(ROWS)), int(r.integers(COLS))
            y[mr * 16:(mr + 1) * 16, mc * 16:(mc + 1) * 16] = \
                r.integers(0, 256, (16, 16)).astype(np.uint8)
        y[1, 1] ^= 1                               # sub-threshold tick
        for p in (prev, None):
            g = dmg.damage_grid_np(y, p)
            np.testing.assert_array_equal(g, j_dmg.damage_grid_np(y, p))
            a, b = dmg.plan_rows(g), j_dmg.plan_rows(g)
            for k in ("rows", "padded"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            assert (a.bucket, a.total, a.frac, a.full) == \
                (b.bucket, b.total, b.frac, b.full)
    for n in range(1, 70):
        assert dmg._bucket_for(n, 68) == j_dmg._bucket_for(n, 68)
    for d in (None, 0.0, 0.3, 1.0, 7.0):
        assert dmg.damage_factor(d, floor=0.2) == j_dmg.damage_factor(
            d, floor=0.2)


@pytest.mark.parametrize("first,fn,qpd,idc", [(0, 0, 0, 2), (40, 3, -4, 1),
                                              (8, 15, 6, 2)])
def test_skip_slices_equal_the_reference(first, fn, qpd, idc):
    assert dmg.skip_slice_nal(first, 8, fn, qpd, idc) == \
        j_dmg.skip_slice_nal(first, 8, fn, qpd, idc)


# -- the compacted P stage ------------------------------------------------

def _planes(rng, h=H, w=W):
    """Gradients with mild noise: residuals the packer's caps take."""
    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        g = (yy * 3 + xx * 2) % 256 + rng.integers(-6, 7, (ph, pw))
        return np.clip(g, 0, 255).astype(np.uint8)
    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


@pytest.mark.parametrize("rows", [[3], [0, 5], [1, 2, 4, 4], [5, 0, 0, 5]])
def test_row_core_equals_the_reference(rows):
    """K5r's and K13's plain versions inside row_core against the
    reference's row_core on random rows with duplicates: flat buffer,
    scattered (deblocked) reference, MVs, levels."""
    rng = np.random.default_rng(len(rows) + rows[0])
    cur, ref = _planes(rng), _planes(rng)
    # the current frame: the reference moved by a few pels, plus noise
    cur = tuple(np.clip(np.roll(p, (1, 3), (0, 1)).astype(int)
                        + rng.integers(-3, 4, p.shape), 0, 255).astype(np.uint8)
                for p in ref)
    qp = 24
    hv, hl = cavlc_device.slice_header_slots(ROWS, COLS, frame_num=2,
                                             qp_delta=-2, slice_type=5,
                                             idr=False, deblocking_idc=2)
    pr = np.asarray(rows, np.int32)
    got = dmg.row_core(*(torch.from_numpy(p) for p in cur + ref),
                       torch.from_numpy(pr),
                       torch.from_numpy(hv.view(np.int32)[pr]),
                       torch.from_numpy(hl[pr]), qp, deblock=True)
    jhv, jhl = j_cavlc.slice_header_slots(ROWS, COLS, frame_num=2,
                                          qp_delta=-2, slice_type=5,
                                          idr=False, deblocking_idc=2)
    want = j_dmg.encode_p_rows(
        *(jnp.asarray(p) for p in cur + ref), jnp.asarray(pr),
        jnp.asarray(np.asarray(jhv)[pr]), jnp.asarray(np.asarray(jhl)[pr]),
        qp, deblock=True)
    flat, wflat = got[0].numpy(), np.asarray(want[0])
    meta = cavlc_device.FlatMeta(flat, len(rows))
    n = cavlc_device.META_WORDS * 4 + 4 * meta.total_words
    assert not meta.overflow
    np.testing.assert_array_equal(flat[:n], wflat[:n])
    assert not wflat[n:].any() and not flat[n:].any()
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f"output {i}")
    np.testing.assert_array_equal(got[5].numpy().reshape(len(rows), COLS, 16),
                                  np.asarray(want[5]).reshape(len(rows),
                                                              COLS, 16))
    for k, v in got[6].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[6][k]),
                                      err_msg=k)


def test_k5r_rows_equal_the_full_frame_rows():
    """A row's search clamps at the frame's edges, not its band's: K5r's
    plain version on a worklist equals the full-frame P core's rows."""
    rng = np.random.default_rng(3)
    cur, ref = _planes(rng), _planes(rng)
    t = [torch.from_numpy(p) for p in cur + ref]
    full = h264_inter.encode_p_frame_plain(*t, 30)
    rows = torch.tensor([5, 0, 2, 2], dtype=torch.int32)
    got = h264_inter.encode_p_frame_rows(*t, rows, 30)
    idx = rows.long()
    for k in ("mv", "luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"):
        assert torch.equal(got[k], full[k][idx]), k
    for k, n in (("recon_y", 16), ("recon_cb", 8), ("recon_cr", 8)):
        want = full[k].view(ROWS, n, -1)[idx].reshape(-1, full[k].shape[1])
        assert torch.equal(got[k], want), k
    with pytest.raises(ValueError):
        h264_inter.encode_p_frame_rows(*t, torch.tensor([6], dtype=torch.int32),
                                       30)


def test_k13_plain_scatters_rows_into_new_planes():
    rng = np.random.default_rng(9)
    ref = [torch.from_numpy(p) for p in _planes(rng)]
    rows = torch.tensor([4, 1, 1], dtype=torch.int32)
    rec = [torch.from_numpy(rng.integers(0, 256, (48, W), np.uint8)),
           torch.from_numpy(rng.integers(0, 256, (24, W // 2), np.uint8)),
           torch.from_numpy(rng.integers(0, 256, (24, W // 2), np.uint8))]
    # the padded duplicate carries the same recon row
    for p, n in zip(rec, (16, 8, 8)):
        p[2 * n:3 * n] = p[n:2 * n]
    before = [p.clone() for p in ref]
    out = dmg.scatter_rows(*ref, *rec, rows)
    for p, q in zip(ref, before):
        assert torch.equal(p, q)                    # the old planes stay
    for o, r, c, n in zip(out, ref, rec, (16, 8, 8)):
        want = r.numpy().copy().reshape(ROWS, n, -1)
        want[[4, 1]] = c.numpy().reshape(3, n, -1)[[0, 1]]
        np.testing.assert_array_equal(o.numpy(), want.reshape(r.shape))


# -- masked encoders against the reference ---------------------------------

def _pair(masked=True, **kw):
    j = JEnc(W, H, damage_mask=masked, **dict(_KW, **kw))
    t = TEnc(W, H, damage_mask=masked, device="cpu", **dict(_KW, **kw))
    return j, t


@pytest.mark.parametrize("pattern",
                         ["single-mb", "dirty-row", "checkerboard", "full"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_masked_aus_equal_the_reference(pattern, chunk, tmp_path):
    """Per frame (gop 8) and in the ring (gop 9, chunk 4), pipelined at
    the encoder's depth: AUs byte-equal to JAX's, every P frame of a
    partial pattern masked, and cv2 decodes the stream."""
    frames = _damage_frames(12 if chunk == 0 else 13, pattern)
    gop = 8 if chunk == 0 else 9
    je, te = _pair(gop=gop, superstep_chunk=chunk)
    kinds = []
    want = _drive(je, frames)
    got = _drive(te, frames, on_submit=lambda tok: kinds.append(tok[0]))
    assert [e.keyframe for e in got] == [i % gop == 0 for i in
                                         range(len(frames))]
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.data == b.data, f"{pattern} chunk {chunk}: frame {i}"
    if pattern in ("single-mb", "dirty-row") and chunk == 0:
        assert kinds.count("p_masked") == len(frames) - 2, kinds
    if pattern in ("single-mb", "dirty-row") and chunk:
        assert te._chunk_steps and all(k[2] > 0 for k in te._chunk_steps), \
            te._chunk_steps.keys()
    path = tmp_path / "m.264"
    path.write_bytes(b"".join(e.data for e in got))
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == len(frames)


@pytest.mark.parametrize("chunk", [0, 4])
def test_full_damage_equals_mask_off(chunk):
    """Fresh noise every frame damages every row: the masked encoder takes
    the full-frame path and gives the mask-off bytes."""
    frames = _damage_frames(9, "full")
    kw = dict(gop=9 if chunk else 8, superstep_chunk=chunk)
    on = _drive(TEnc(W, H, damage_mask=True, device="cpu", **_KW, **kw),
                frames)
    off = _drive(TEnc(W, H, damage_mask=False, device="cpu", **_KW, **kw),
                 frames)
    assert [e.data for e in on] == [e.data for e in off]


@pytest.mark.parametrize("chunk", [0, 4])
def test_masked_overflow_scatters_levels_to_the_host_coder(chunk,
                                                           monkeypatch):
    """A damaged row of noise at qp 8 passes the packer's per-MB cap: the
    compacted levels go through scatter_levels_np to the host coder, with
    the reference's bytes."""
    calls = []
    real = dmg.scatter_levels_np

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dmg, "scatter_levels_np", spy)
    frames = _damage_frames(6, "dirty-row")
    je, te = _pair(gop=16, superstep_chunk=chunk, qp=8)
    want = _drive(je, frames)
    got = _drive(te, frames)
    assert [e.data for e in want] == [e.data for e in got]
    assert calls, "no masked frame overflowed"


def test_masked_stream_decodes_to_the_references(tmp_path):
    """cv2's luma of a masked per-frame stream equals the encoder's
    deblocked references frame for frame (skip rows included)."""
    frames = _damage_frames(8, "single-mb")
    te = TEnc(W, H, gop=8, damage_mask=True, deblock=True, device="cpu",
              **_KW)
    refs, aus = [], []
    for f in frames:
        aus.append(te.encode_collect(te.encode_submit(f)).data)
        refs.append(te._ref[0].numpy().copy())
    path = tmp_path / "d.264"
    path.write_bytes(b"".join(aus))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, ref in enumerate(refs):
        ok, img = cap.read()
        assert ok, f"cv2 stopped at frame {i}"
        np.testing.assert_array_equal(img.reshape(H, W), ref, f"frame {i}")
    cap.release()
    p_nals = [au.split(syn.START_CODE)[1:] for au in aus[1:]]
    assert all(len(n) == ROWS for n in p_nals)
