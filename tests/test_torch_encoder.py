"""The all-intra encoder slice end to end: the port's ``make_encoder`` /
``encode_submit`` / ``encode_collect`` against the reference encoder on the
same frames — AU bytes equal every frame, with the rate controller moving
qp, through the overflow fallback and across a state handoff."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device
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
        elif a[k] is None or isinstance(a[k], (str, dict)):
            assert a[k] == b[k], k
        elif k in ("act_p50", "act_p95"):
            assert b[k] == pytest.approx(a[k], rel=1e-6), k
        elif k == "psnr_db":               # the reference's documented dB
            assert abs(a[k] - b[k]) <= 0.01, k
        elif k in ("mv_mean_qpel", "mv_p95_qpel"):   # float32 sums there
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
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


# --- the GOP path: IDR, P frames, deblock, two frames in flight ----------

GW, GH = 72, 40                            # padded to 80 x 48: cropping
# qp 28 and 22 on the IDRs, 18-22 on the P frames: few distinct qps (each
# is a compile of the reference's static-qp programs), 18 low enough for
# a noise P frame to overflow the packer
GOP_ENV = {"ENCODER_BITRATE_KBPS": "500", "ENCODER_QP": "20"}


def _gop_pair(**env):
    e = dict({"SIZEW": str(GW), "SIZEH": str(GH)}, **env)
    je, te = j_make(j_env(e), GW, GH)[0], t_make(t_env(e), GW, GH,
                                                  device="cpu")[0]
    assert te.gop == je.gop == 60 and te.deblock and je.deblock
    return je, te


def _gop_frames(n, noisy_at=None, seed=11):
    frames = _frames(GW, GH, n, seed=seed)
    if noisy_at is not None:
        frames[noisy_at] = np.random.default_rng(seed).integers(
            0, 256, (GH, GW, 3), np.uint8)
    return frames


@pytest.fixture(scope="module")
def gop_run():
    """Both encoders over one GOP stream, two frames in flight: IDR, P
    frames, a requested keyframe, a noise P frame that overflows the
    packer, the RateController moving qp.  Records what each side
    produced per collected frame."""
    je, te = _gop_pair(**GOP_ENV)
    je.keep_recon = te.keep_recon = True
    n, kf_at, noisy_at = 12, 6, 9
    frames = _gop_frames(n, noisy_at=noisy_at)
    run = {"te": te, "frames": frames, "aus": [], "refs": [], "keys": [],
           "qps": [], "kinds": [], "overflow": []}
    jt, tt = [], []
    for i, f in enumerate(frames + [None]):
        if f is not None:
            if i == kf_at:
                je.request_keyframe()
                te.request_keyframe()
            jt.append(je.encode_submit(f))
            tt.append(te.encode_submit(f))
            # the reference each side will predict the next frame from
            jref = tuple(np.asarray(p) for p in je._ref)
            tref = tuple(p.numpy() for p in te._ref)
            for a, b in zip(jref, tref):
                np.testing.assert_array_equal(a, b, err_msg=f"ref {i}")
            run["refs"].append(tref)
            run["qps"].append(tt[-1][4][0] if tt[-1][0] == "p"
                              else tt[-1][4][2])
            run["kinds"].append(tt[-1][0])
        if len(jt) == 2 or (f is None and jt):
            prefix = tt[0][4][5][0]
            run["overflow"].append(
                cavlc_device.FlatMeta(prefix.numpy(), te.mb_h).overflow)
            a, b = je.encode_collect(jt.pop(0)), te.encode_collect(tt.pop(0))
            assert a.data == b.data, f"frame {a.frame_index}"
            assert (a.frame_index, a.keyframe) == (b.frame_index, b.keyframe)
            for p, q in zip(je.last_recon, te.last_recon):
                np.testing.assert_array_equal(p, q, err_msg=f"recon "
                                              f"{a.frame_index}")
            _same_stats(je.pop_content_stats(), te.pop_content_stats())
            run["aus"].append(b.data)
            run["keys"].append(b.keyframe)
    assert je._rate._ema == te._rate._ema and je._rate.level == te._rate.level
    return run


def test_gop_stream_equals_reference_pipelined(gop_run):
    run = gop_run
    assert run["keys"] == [i in (0, 6) for i in range(12)]
    assert run["kinds"] == ["intra" if i in (0, 6) else "p" for i in range(12)]
    assert len(set(run["qps"])) > 1, run["qps"]
    te = run["te"]
    types = [{n[0] & 0x1F for n in au.split(syn.START_CODE)[1:]}
             for au in run["aus"]]
    assert types[0] == types[6] == {syn.NAL_SPS, syn.NAL_PPS, syn.NAL_IDR}
    assert all(t == {syn.NAL_SLICE} for i, t in enumerate(types)
               if i not in (0, 6))
    # the noise frame (and the frame predicted from it) took the host
    # fallback of the P path
    assert run["overflow"][9] and not any(run["overflow"][:9])
    assert te._p_pull_guess is not None


def test_gop_stream_decodes_to_the_deblocked_references(gop_run, tmp_path):
    path = tmp_path / "gop.264"
    path.write_bytes(b"".join(gop_run["aus"]))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)       # the decoder's own luma plane
    for i, ref in enumerate(gop_run["refs"]):
        ok, img = cap.read()
        assert ok, f"cv2 stopped at frame {i}"
        np.testing.assert_array_equal(img.reshape(GH, GW), ref[0][:GH, :GW],
                                      err_msg=f"frame {i}")
    cap.release()


def test_gop_state_from_the_reference_mid_gop_gives_the_same_bytes():
    env = GOP_ENV
    frames = _gop_frames(9)
    je, _ = _gop_pair(**env)
    for f in frames[:4]:
        je.encode(f)
    state = je.export_state()
    assert state["gop_pos"] == 4 and state["frame_num"] == 3
    assert state["idr_count"] == 1 and state["rate"]["ema_p"] is not None
    j2, te = _gop_pair(**env)
    j2.import_state(state)
    te.import_state(state)
    for i, f in enumerate(frames[4:]):
        a, b = j2.encode(f), te.encode(f)
        assert a.data == b.data and a.frame_index == b.frame_index, i
        assert a.keyframe == b.keyframe == (i == 0)
    st = te.export_state()
    for k in ("gop_pos", "frame_num", "idr_count", "frame_index", "rate"):
        assert st[k] == j2.export_state()[k], k
