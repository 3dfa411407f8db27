"""ENCODER_TUNE=hq's full tier end to end against the reference encoder
(``deblock=False``: the qp plane, the qp chain, I16-in-P, the keyframe qp
bias and the rate model's mean-coded-qp normalisation), per frame with
two frames in flight, in the chunk ring with the 1-frame lookahead, under
CABAC, across a P overflow and a mid-GOP state import; every access unit
byte-equal, and cv2 decodes the stream to the port's recon.  The served
tier (``make_encoder``) is ``test_torch_tune_served.py``."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.models.h264 import H264Encoder as JEnc
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.models.h264 import H264Encoder as TEnc
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

import conftest

cv2 = pytest.importorskip("cv2")

W, H = 72, 40                              # padded to 80 x 48: cropping
# the full tier's runs share one rate: the controller codes their IDRs at
# 25 (its keyframe qp less I_QP_BIAS) and their P frames at QP, few
# distinct qps (each is a compile of the reference's static-qp programs),
# low enough that a noise P frame overflows the packer
QP = 20
FULL = dict(mode="cavlc", entropy="device", deblock=False, tune="hq",
            gop=60, host_color=True, qp=QP, bitrate_kbps=450)


def _frames(n, seed=11, noisy_at=None):
    """A desktop with a scrolling band, a moving window and, every third
    frame, a new flat panel over the noise (the I16-in-P territory)."""
    base = conftest.make_test_frame(H, W, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = base.copy()
        f[H // 2:] = np.roll(base[H // 2:], 3 * i, axis=1)
        f[4:14, 2 + 5 * i:14 + 5 * i] = (20 * i, 200, 90)
        if i % 3 == 2:
            f[18:38, 24:64] = (120 + 10 * i, 128, 128)
        out.append(f)
    if noisy_at is not None:
        out[noisy_at] = rng.integers(0, 256, (H, W, 3), np.uint8)
    return out


def _run_pair(je, te, frames, depth=2, keyframe_at=()):
    """Both encoders over ``frames`` at ``depth`` in flight; asserts the
    AUs equal and returns the port's (tokens, AUs, recons, refs)."""
    jt, tt, toks, aus, recons, refs = [], [], [], [], [], []
    for i, f in enumerate(list(frames) + [None]):
        if f is not None:
            if i in keyframe_at:
                je.request_keyframe()
                te.request_keyframe()
            jt.append(je.encode_submit(f))
            tt.append(te.encode_submit(f))
            toks.append(tt[-1])
            if te._ref is not None:
                refs.append(tuple(p.numpy().copy() for p in te._ref))
        while len(jt) >= depth or (f is None and jt):
            a, b = je.encode_collect(jt.pop(0)), te.encode_collect(tt.pop(0))
            assert a.data == b.data, f"frame {a.frame_index}"
            assert (a.frame_index, a.keyframe) == (b.frame_index, b.keyframe)
            aus.append(b.data)
            if te.keep_recon:
                recons.append(te.last_recon)
    return toks, aus, recons, refs


def _decoded_luma(aus, tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"".join(aus))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(np.asarray(img).reshape(H, W))
    cap.release()
    return out


@pytest.fixture(scope="module")
def full_run():
    """The full tier, two frames in flight, under rate control: an IDR at
    its biased qp, P frames with I16-in-P, the rate model normalised by
    each frame's mean coded qp."""
    je, te = JEnc(W, H, **FULL), TEnc(W, H, device="cpu", **FULL)
    assert (te._ktune, te._p_intra) == (je._ktune, je._p_intra) == ("hq", True)
    je.keep_recon = te.keep_recon = True
    intra = []

    def spy(orig):
        def submit(planes, qp, frame_num=None, next_y=None):
            sub = orig(planes, qp, frame_num, next_y)
            intra.append(bool(sub[2]["mb_intra"].any()))
            return sub
        return submit

    te._submit_p_device = spy(te._submit_p_device)
    toks, aus, recons, _ = _run_pair(je, te, _frames(6))
    return {"je": je, "te": te, "toks": toks, "aus": aus, "recons": recons,
            "intra": intra}


def test_full_tier_stream_equals_reference(full_run):
    je, te, toks = full_run["je"], full_run["te"], full_run["toks"]
    assert je._rate._ema == te._rate._ema and je._rate.level == te._rate.level
    assert te._rate._ema[False] is not None
    assert toks[0][0] == "intra" and toks[0][4][2] == 25
    assert {t[4][0] for t in toks[1:]} == {QP}
    assert any(full_run["intra"]), "no I16-in-P MB"


def test_full_tier_p_overflow_takes_the_host_coder():
    """A noise P frame past the packer's caps: the host coder codes the
    device stage's own levels with the qp plane and I16-in-P tensors."""
    je, te = JEnc(W, H, **FULL), TEnc(W, H, device="cpu", **FULL)
    toks, _, _, _ = _run_pair(je, te, _frames(3, noisy_at=1))
    overflow = [cavlc_device.FlatMeta(t[4][5][0].numpy(), te.mb_h).overflow
                for t in toks[1:]]
    assert overflow[0]


@pytest.mark.parametrize("tune,deblock,want", [("hq", False, (27, 30)),
                                               ("hq", True, (30, 30)),
                                               ("off", False, (30, 30))])
def test_keyframe_qp_bias_only_under_the_full_tier(tune, deblock, want):
    kw = dict(FULL, tune=tune, deblock=deblock, qp=30, bitrate_kbps=0)
    te, je = TEnc(W, H, device="cpu", **kw), JEnc(W, H, **kw)
    assert (te._eff_qp(True), te._eff_qp(False)) == want
    assert (je._eff_qp(True), je._eff_qp(False)) == want


def test_unknown_tune_warns_and_serves_off(caplog):
    with caplog.at_level("WARNING"):
        te = TEnc(W, H, device="cpu", **dict(FULL, tune="hq2"))
    je = JEnc(W, H, **dict(FULL, tune="hq2"))
    assert (te.tune, te._ktune, te._p_intra) == ("off", "off", False)
    assert (je.tune, je._ktune) == ("off", "off")
    assert "unknown ENCODER_TUNE" in caplog.text


@pytest.mark.parametrize("kw", [dict(tune="hq", entropy="cabac"),
                                dict(tune="hq", p_intra=True, deblock=True),
                                dict(tune="off", p_intra=True,
                                     deblock=False)])
def test_chunk_step_refuses_what_the_reference_refuses(kw):
    from docker_nvidia_glx_desktop_tpu_torch.ops import devloop

    kw = dict(dict(deblock=False, entropy="cavlc"), **kw)
    with pytest.raises(ValueError):
        devloop.ChunkStep(chunk=4, pad_h=48, pad_w=80, **kw)


def test_full_tier_stream_decodes_to_the_recon(full_run, tmp_path):
    dec = _decoded_luma(full_run["aus"], tmp_path, "full.264")
    assert len(dec) == len(full_run["recons"]) == 6
    for i, (d, r) in enumerate(zip(dec, full_run["recons"])):
        np.testing.assert_array_equal(d, r[0][:H, :W], err_msg=f"frame {i}")


def test_full_tier_ring_with_lookahead_equals_reference_ring():
    kw = dict(FULL, superstep_chunk=4)
    je, te = JEnc(W, H, **kw), TEnc(W, H, device="cpu", **kw)
    assert te._ring_chunk == je._ring_chunk == 4
    # an IDR, a chunk, and a frame staged at the end: drained through the
    # per-frame path, where it sees itself as the lookahead
    toks, aus, _, _ = _run_pair(je, te, _frames(6, seed=5),
                                depth=te.pipeline_depth)
    assert [t[0] for t in toks] == ["intra"] + ["ring"] * 5


def test_full_tier_cabac_takes_the_host_transport_and_equals_reference(
        monkeypatch):
    """Full-tier CABAC codes through the level transport with the qp
    plane, whatever ENCODER_CABAC_BINARIZE asks for (the reference warns
    and does the same)."""
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")
    kw = dict(FULL, entropy="cabac")
    je, te = JEnc(W, H, **kw), TEnc(W, H, device="cpu", **kw)
    assert not te.cabac_device_binarize and not te._p_intra
    _run_pair(je, te, _frames(4, seed=7))


def test_state_from_the_reference_mid_gop_gives_the_same_bytes():
    kw = FULL
    frames = _frames(7, seed=9)
    je = JEnc(W, H, **kw)
    for f in frames[:3]:
        je.encode(f)
    state = je.export_state()
    assert state["gop_pos"] == 3
    j2, te = JEnc(W, H, **kw), TEnc(W, H, device="cpu", **kw)
    j2.import_state(state)
    te.import_state(state)
    for i, f in enumerate(frames[3:]):
        a, b = j2.encode(f), te.encode(f)
        assert a.data == b.data and a.keyframe == b.keyframe == (i == 0), i
    assert j2._rate._ema == te._rate._ema
