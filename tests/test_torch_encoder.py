"""The all-intra encoder slice end to end: the port's ``make_encoder`` /
``encode_submit`` / ``encode_collect`` against the reference encoder on the
same frames — AU bytes equal every frame, with the rate controller moving
qp, through the overflow fallback and across a state handoff."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env
from docker_nvidia_glx_desktop_tpu_torch.utils.hostcolor import (
    rgb_to_yuv420_host)

import conftest

cv2 = pytest.importorskip("cv2")


def _pair(w, h, **env):
    e = dict({"SIZEW": str(w), "SIZEH": str(h), "ENCODER_GOP": "1"}, **env)
    return j_make(j_env(e), w, h)[0], t_make(t_env(e), w, h, device="cpu")[0]


def _frames(w, h, n, seed=0):
    """Desktop-like frames with a scrolling band and a moving window."""
    base = conftest.make_test_frame(h, w, seed=seed)
    out = []
    for i in range(n):
        f = base.copy()
        f[h // 2:] = np.roll(base[h // 2:], 3 * i, axis=1)
        f[4:14, 2 + 5 * i:14 + 5 * i] = (20 * i, 200, 90)
        out.append(f)
    return out


def _same_stats(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k in ("act_p50", "act_p95"):
            assert b[k] == pytest.approx(a[k], rel=1e-6), k
        else:
            assert a[k] == b[k], k


def test_pipelined_aus_equal_with_rate_control_moving_qp():
    w, h = 72, 40                          # padded to 80 x 48: cropping
    je, te = _pair(w, h, ENCODER_BITRATE_KBPS="250")
    frames = _frames(w, h, 6)
    qps = []
    jt, tt = [], []
    for i, f in enumerate(frames + [None]):
        if f is not None:                  # one frame in flight, as serving
            jt.append(je.encode_submit(f))
            tt.append(te.encode_submit(f))
        if len(jt) == 2 or (f is None and jt):
            a, b = je.encode_collect(jt.pop(0)), te.encode_collect(tt.pop(0))
            assert a.data == b.data, f"frame {a.frame_index}"
            assert (a.frame_index, a.keyframe) == (b.frame_index, b.keyframe)
            _same_stats(je.pop_content_stats(), te.pop_content_stats())
            qps.append(te._rate.qp)
    assert len(qps) == 6 and len(set(qps)) > 1, qps
    assert je._rate.level == te._rate.level
    assert je._rate._ema == te._rate._ema


def test_aus_decode_with_cv2(tmp_path):
    w, h = 64, 48
    _, te = _pair(w, h, ENCODER_BITRATE_KBPS="0", ENCODER_QP="22")
    te.keep_recon = True
    f = _frames(w, h, 1, seed=3)[0]
    f[h // 2:h // 2 + h // 8] = 120      # no random band: smooth content
    ef = te.encode(f)
    p = tmp_path / "port.264"
    p.write_bytes(ef.data)
    cap = cv2.VideoCapture(str(p))
    ok, img = cap.read()
    cap.release()
    assert ok, "cv2 rejected the port's stream"
    dec_y = rgb_to_yuv420_host(np.ascontiguousarray(img[:, :, ::-1]), h, w)[0]
    src_y = rgb_to_yuv420_host(f, h, w)[0]

    def psnr(a, b):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        mse = np.mean(d * d)
        return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

    assert psnr(dec_y, src_y) > 35
    # the decoder reconstructs what the encoder's recon says (colour
    # round trip through BGR costs a little)
    assert psnr(dec_y, te.last_recon[0][:h, :w]) > 40


def test_overflow_fallback_au_equals_reference():
    w, h = 64, 48
    je, te = _pair(w, h, ENCODER_BITRATE_KBPS="0", ENCODER_QP="1")
    noise = np.random.default_rng(7).integers(0, 256, (h, w, 3), np.uint8)
    tok = te.encode_submit(noise)
    from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device
    _, _, _, _, flat, (prefix, _), _ = tok[4]
    assert cavlc_device.FlatMeta(prefix.numpy(), te.mb_h).overflow
    a = je.encode_collect(je.encode_submit(noise))
    assert te.encode_collect(tok).data == a.data


def test_state_handoff_from_the_reference_continues_its_stream():
    w, h = 64, 48
    env = {"ENCODER_BITRATE_KBPS": "250"}
    je, _ = _pair(w, h, **env)
    frames = _frames(w, h, 6, seed=5)
    for f in frames[:3]:
        je.encode(f)
    state = je.export_state()
    _, te = _pair(w, h, **env)
    te.import_state(state)
    assert te.frame_index == 3
    for f in frames[3:]:
        a, b = je.encode(f), te.encode(f)
        assert a.data == b.data and a.frame_index == b.frame_index
    st = te.export_state()
    for k in ("schema", "codec", "width", "height", "frame_index",
              "pull_guess", "rate"):
        assert st[k] == je.export_state()[k], k
