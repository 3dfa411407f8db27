"""The CABAC serving path end to end (``ENCODER_ENTROPY=cabac``): the
port's ``make_encoder`` / ``encode_submit`` / ``encode_collect`` against
the reference encoder on both transports (``ENCODER_CABAC_BINARIZE=host``,
the level pack; ``=device``, the record streams) — access units, recon
and deblocked references equal every frame over an IDR and P frames with
deblock, the rate controller moving qp and two frames in flight, through
a P frame that falls back to the dense coder, across a mid-GOP state
handoff — and cv2 decoding the stream to the deblocked references."""

import numpy as np
import pytest

from docker_nvidia_glx_desktop_tpu.models import make_encoder as j_make
from docker_nvidia_glx_desktop_tpu.utils.config import from_env as j_env
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264 as syn
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_cabac
from docker_nvidia_glx_desktop_tpu_torch.models import make_encoder as t_make
from docker_nvidia_glx_desktop_tpu_torch.native import lib as native_lib
from docker_nvidia_glx_desktop_tpu_torch.ops import level_pack
from docker_nvidia_glx_desktop_tpu_torch.utils.config import from_env as t_env

import conftest
from test_torch_encoder import _same_stats

cv2 = pytest.importorskip("cv2")

W, H = 72, 40                              # padded to 80 x 48: cropping
# few distinct qps (each one a compile of the reference's programs)
ENV = {"SIZEW": str(W), "SIZEH": str(H), "ENCODER_ENTROPY": "cabac",
       "ENCODER_BITRATE_KBPS": "500", "ENCODER_QP": "20"}
N = 8


def _pair(**env):
    e = dict(ENV, **env)
    (je, jc), (te, tc) = j_make(j_env(e), W, H), t_make(t_env(e), W, H,
                                                         device="cpu")
    assert jc == tc == "h264_cabac"
    assert te.gop == je.gop == 60 and te.deblock and je.deblock
    return je, te


def _frames(n, noisy_at=None, seed=11):
    base = conftest.make_test_frame(H, W, seed=seed)
    out = []
    for i in range(n):
        f = base.copy()
        f[H // 2:] = np.roll(base[H // 2:], 3 * i, axis=1)
        f[4:14, 2 + 5 * i:14 + 5 * i] = (20 * i, 200, 90)
        out.append(f)
    if noisy_at is not None:
        out[noisy_at] = np.random.default_rng(seed).integers(
            0, 256, (H, W, 3), np.uint8)
    return out


@pytest.fixture(scope="module", params=["host", "device"])
def cabac_run(request):
    """Both encoders over one GOP stream on one transport, two frames in
    flight, keep_recon on; every AU, recon, reference and stats checked
    as it is collected."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ENCODER_CABAC_BINARIZE", request.param)
        je, te = _pair()
        je.keep_recon = te.keep_recon = True
        frames = _frames(N)
        run = {"route": request.param, "te": te, "aus": [], "refs": [],
               "qps": [], "kinds": [], "overflow": []}
        calls0 = dict(native_lib.calls)
        py0 = h264_cabac.python_pictures
        jt, tt = [], []
        for f in frames + [None]:
            if f is not None:
                jt.append(je.encode_submit(f))
                tt.append(te.encode_submit(f))
                for a, b in zip(je._ref, te._ref):
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())
                run["refs"].append(tuple(p.numpy() for p in te._ref))
                run["kinds"].append(tt[-1][0])
                run["qps"].append(tt[-1][4][5])
            if len(jt) == 2 or (f is None and jt):
                host, _ = tt[0][4][3]
                run["overflow"].append(bool(host.numpy()[1]))
                a, b = je.encode_collect(jt.pop(0)), te.encode_collect(
                    tt.pop(0))
                assert a.data == b.data, f"frame {a.frame_index}"
                assert (a.frame_index, a.keyframe) == (b.frame_index,
                                                       b.keyframe)
                for p, q in zip(je.last_recon, te.last_recon):
                    np.testing.assert_array_equal(p, q)
                _same_stats(je.pop_content_stats(), te.pop_content_stats())
                run["aus"].append(b.data)
        assert je._rate._ema == te._rate._ema
        assert je._rate.level == te._rate.level
        run["calls"] = {k: native_lib.calls[k] - calls0.get(k, 0)
                        for k in native_lib.calls}
        run["python_pictures"] = h264_cabac.python_pictures - py0
        return run


def test_cabac_stream_equals_reference_pipelined(cabac_run):
    run = cabac_run
    assert run["kinds"] == ["cabac_intra"] + ["cabac_p"] * (N - 1)
    assert len(set(run["qps"])) > 1, run["qps"]
    types = [{n[0] & 0x1F for n in au.split(syn.START_CODE)[1:]}
             for au in run["aus"]]
    assert types[0] == {syn.NAL_SPS, syn.NAL_PPS, syn.NAL_IDR}
    assert all(t == {syn.NAL_SLICE} for t in types[1:])
    # the Main-profile SPS and the cabac PPS
    nals = run["aus"][0].split(syn.START_CODE)[1:]
    assert nals[0][1] == 77                          # profile_idc: Main
    assert run["python_pictures"] == 0 and not any(run["overflow"])
    # each route's own native entry points coded every frame and the
    # other route's never ran: no device-route frame went dense
    want = ({"level_unpack_rows": N, "h264_cabac_intra_slices": 1,
             "h264_cabac_p_slices": N - 1, "h264_cabac_engine_rows": 0}
            if run["route"] == "host" else
            {"level_unpack_rows": 0, "h264_cabac_intra_slices": 0,
             "h264_cabac_p_slices": 0, "h264_cabac_engine_rows": N})
    assert {k: run["calls"].get(k, 0) for k in want} == want


def test_record_overflow_p_frame_takes_the_dense_coder(monkeypatch):
    """At qp 8 a noise P frame's levels pass the record budget (|AC
    level| > 141): its transport flags overflow and the native coder
    codes it from the dense levels; the bytes stay the reference's."""
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", "device")
    je, te = _pair(ENCODER_BITRATE_KBPS="0", ENCODER_QP="8")
    frames = _frames(3, noisy_at=1, seed=6)
    py0 = h264_cabac.python_pictures
    for i, f in enumerate(frames):
        tok = te.encode_submit(f)
        overflow = bool(tok[4][3][0].numpy()[1])
        assert tok[0] == ("cabac_intra" if i == 0 else "cabac_p")
        assert overflow or i != 1
        assert je.encode(f).data == te.encode_collect(tok).data, i
    assert h264_cabac.python_pictures == py0


def test_cabac_stream_decodes_to_the_deblocked_references(cabac_run,
                                                         tmp_path):
    path = tmp_path / "cabac.264"
    path.write_bytes(b"".join(cabac_run["aus"]))
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for i, ref in enumerate(cabac_run["refs"]):
        ok, img = cap.read()
        assert ok, f"cv2 stopped at frame {i}"
        np.testing.assert_array_equal(img.reshape(H, W), ref[0][:H, :W],
                                      err_msg=f"frame {i}")
    cap.release()


def test_level_pack_overflow_falls_back_to_the_dense_levels(monkeypatch):
    """The host route's value-overflow flag (levels past +-16383) sends
    IDR and P frames to the dense coder; the bytes stay the reference's."""
    orig = level_pack.pack_levels

    def claims_overflow(levels, keys):
        buf = orig(levels, keys)
        buf[1] = 1
        return buf

    je, te = _pair(ENCODER_BITRATE_KBPS="0")
    monkeypatch.setattr(level_pack, "pack_levels", claims_overflow)
    for f in _frames(3, seed=4):
        assert je.encode(f).data == te.encode(f).data


@pytest.mark.parametrize("route", ["host", "device"])
def test_cabac_state_from_the_reference_mid_gop_gives_the_same_bytes(
        route, monkeypatch):
    monkeypatch.setenv("ENCODER_CABAC_BINARIZE", route)
    frames = _frames(7, seed=5)
    je, _ = _pair()
    for f in frames[:4]:
        je.encode(f)
    state = je.export_state()
    assert state["gop_pos"] == 4 and state["frame_num"] == 3
    j2, te = _pair()
    j2.import_state(state)
    te.import_state(state)
    for i, f in enumerate(frames[4:]):
        a, b = j2.encode(f), te.encode(f)
        assert a.data == b.data and a.frame_index == b.frame_index, i
        assert a.keyframe == b.keyframe == (i == 0)
    st = te.export_state()
    for k in ("gop_pos", "frame_num", "idr_count", "frame_index", "rate"):
        assert st[k] == j2.export_state()[k], k
