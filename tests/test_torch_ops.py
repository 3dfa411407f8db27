"""Transform, quant and table primitives of the PyTorch port held equal to
the JAX reference (exact: all integer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docker_nvidia_glx_desktop_tpu.ops import aq as j_aq
from docker_nvidia_glx_desktop_tpu.ops import cavlc_device as j_cavlc
from docker_nvidia_glx_desktop_tpu.ops import dct as j_dct
from docker_nvidia_glx_desktop_tpu.ops import h264_device as j_intra
from docker_nvidia_glx_desktop_tpu.ops import quant as j_quant
from docker_nvidia_glx_desktop_tpu.ops import scan as j_scan
from docker_nvidia_glx_desktop_tpu.bitstream import h264_entropy as j_ent
from docker_nvidia_glx_desktop_tpu_torch.ops import aq as t_aq
from docker_nvidia_glx_desktop_tpu_torch.ops import cavlc_device as t_cavlc
from docker_nvidia_glx_desktop_tpu_torch.ops import dct as t_dct
from docker_nvidia_glx_desktop_tpu_torch.ops import h264_device as t_intra
from docker_nvidia_glx_desktop_tpu_torch.ops import quant as t_quant
from docker_nvidia_glx_desktop_tpu_torch.ops import scan as t_scan
from docker_nvidia_glx_desktop_tpu_torch.bitstream import h264_entropy as t_ent


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_zigzag_tables_and_scans():
    assert (j_scan.ZIGZAG4 == t_scan.ZIGZAG4).all()
    assert (j_scan.ZIGZAG8 == t_scan.ZIGZAG8).all()
    b = np.random.default_rng(0).integers(-99, 99, (5, 4, 4)).astype(np.int32)
    _eq(j_scan.zigzag(b, 4), t_scan.zigzag(torch.from_numpy(b), 4))
    z = np.asarray(j_scan.zigzag(b, 4))
    _eq(j_scan.unzigzag(z, 4), t_scan.unzigzag(torch.from_numpy(z), 4))


@pytest.mark.parametrize("name,lo,hi", [
    ("fdct4x4", -255, 256), ("idct4x4", -4096, 4096),
    ("hadamard4x4", -9000, 9000), ("hadamard2x2", -9000, 9000)])
def test_integer_transforms(name, lo, hi):
    shape = (64, 2, 2) if name == "hadamard2x2" else (64, 4, 4)
    x = np.random.default_rng(1).integers(lo, hi, shape).astype(np.int32)
    _eq(getattr(j_dct, name)(x), getattr(t_dct, name)(torch.from_numpy(x)))


@pytest.mark.parametrize("qp", [0, 5, 11, 12, 26, 37, 51])
def test_quant_dequant(qp):
    rng = np.random.default_rng(qp)
    w = torch.from_numpy(rng.integers(-9180, 9181, (32, 4, 4)).astype(np.int32))
    dc = torch.from_numpy(rng.integers(-32640, 32641, (32, 4, 4)).astype(np.int32))
    lv = torch.from_numpy(rng.integers(-300, 301, (32, 4, 4)).astype(np.int32))
    wn = w.numpy()
    for intra in (True, False):
        _eq(j_quant.h264_quantize_4x4(wn, qp, intra=intra),
            t_quant.h264_quantize_4x4(w, qp, intra=intra))
        _eq(j_quant.h264_quantize_chroma_dc(dc.numpy(), qp, intra=intra),
            t_quant.h264_quantize_chroma_dc(dc, qp, intra=intra))
    _eq(j_quant.h264_dequantize_4x4(lv.numpy(), qp),
        t_quant.h264_dequantize_4x4(lv, qp))
    _eq(j_quant.h264_quantize_luma_dc(dc.numpy(), qp),
        t_quant.h264_quantize_luma_dc(dc, qp))
    _eq(j_quant.h264_dequantize_luma_dc(lv.numpy(), qp),
        t_quant.h264_dequantize_luma_dc(lv, qp))
    _eq(j_quant.h264_dequantize_chroma_dc(lv.numpy(), qp),
        t_quant.h264_dequantize_chroma_dc(lv, qp))


def test_chroma_qp_and_quant_tables():
    assert (j_quant.MF_TABLE == t_quant.MF_TABLE).all()
    assert (j_quant.V_TABLE == t_quant.V_TABLE).all()
    for qp in range(52):
        for off in (-12, 0, 5):
            assert j_quant.chroma_qp(qp, off) == t_quant.chroma_qp(qp, off)


def test_cavlc_tables_equal_the_reference():
    for name in ("_CT_PACKED", "_TZ_PACKED", "_TZC_PACKED", "_RB_PACKED",
                 "_UE_VAL", "_UE_LEN", "_CT_LEN", "_CT_BITS", "_TZ_LEN",
                 "_TZ_BITS", "_TZC_LEN", "_TZC_BITS", "_RB_LEN", "_RB_BITS"):
        np.testing.assert_array_equal(getattr(j_cavlc, name),
                                      getattr(t_cavlc, name), err_msg=name)
    assert (j_ent._CBP_INTRA_TO_CODENUM == t_ent._CBP_INTRA_TO_CODENUM).all()
    for name in ("MB_SYN_SLOTS", "BLOCK_SLOTS", "MB_BLOCKS", "HDR_SLOTS",
                 "META_WORDS", "MAX_META_ROWS", "FLAT_CAP_WORDS",
                 "META_QP_SUM_WORD"):
        assert getattr(j_cavlc, name) == getattr(t_cavlc, name), name


def test_level_bit_estimate_every_quantizer_magnitude():
    """floor(log2) of every magnitude the quantizer emits (< 2^16), as the
    reference's float32 log2 computes it."""
    a = np.arange(-(1 << 16), 1 << 16, dtype=np.int32).reshape(-1, 16)
    _eq(j_intra._level_bits_est(jnp.asarray(a), (1,)),
        t_intra._level_bits_est(torch.from_numpy(a), (1,)))


def test_mb_activity():
    y = np.random.default_rng(3).integers(0, 256, (48, 64)).astype(np.uint8)
    y[:16, :16] = 255
    y[16:32, :16] = np.tile([0, 255], (16, 8))
    _eq(j_aq.mb_activity(y), t_aq.mb_activity(torch.from_numpy(y)))


def test_code_blocks_escapes_and_runs():
    """The block coder on random levels, including large escapes and
    chroma-DC blocks, against the reference's block coder."""
    rng = np.random.default_rng(4)
    n = 256
    lv = rng.integers(-3, 4, (n, 16)) * (rng.random((n, 16)) < 0.4)
    lv[::7, 3] = rng.integers(-5000, 5000, len(lv[::7]))
    lv[::11, :] = 0
    is_cdc = np.zeros(n, bool)
    is_cdc[::5] = True
    max_coeff = np.where(is_cdc, 4, np.where(np.arange(n) % 2, 15, 16))
    lv[is_cdc, 4:] = 0
    lv[max_coeff == 15, 15] = 0
    nc = rng.integers(0, 17, n)
    jv, jl = j_cavlc.code_blocks(jnp.asarray(lv, jnp.int32), jnp.asarray(nc),
                                 jnp.asarray(is_cdc), jnp.asarray(max_coeff))
    tv, tl = t_cavlc.code_blocks(torch.from_numpy(lv), torch.from_numpy(nc),
                                 torch.from_numpy(is_cdc),
                                 torch.from_numpy(max_coeff))
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jv).astype(np.int64), tv.numpy())


def test_slice_header_slots():
    for kw in ({"frame_num": 0, "idr_pic_id": 1, "qp_delta": 6,
                "deblocking_idc": 2},
               {"frame_num": 0, "idr_pic_id": 0, "qp_delta": -3}):
        jv, jl = j_cavlc.slice_header_slots(68, 120, **kw)
        tv, tl = t_cavlc.slice_header_slots(68, 120, **kw)
        assert (jv == tv).all() and (jl == tl).all()


def test_qp_chain_np():
    rng = np.random.default_rng(5)
    qp_map = rng.integers(20, 40, (3, 7))
    codes = rng.random((3, 7)) < 0.5
    for a, b in zip(j_aq.qp_chain_np(qp_map, codes, 26),
                    t_aq.qp_chain_np(qp_map, codes, 26)):
        assert (a == b).all()
