"""H.264 (ISO/IEC 14496-10) bitstream syntax: Exp-Golomb, NAL wrapping,
SPS/PPS/slice headers.

This replaces the bitstream-construction half of the reference's
``nvh264enc`` element (reference Dockerfile:210): NVENC emits Annex-B NAL
units in silicon; we emit them first-party.  Only baseline-profile intra
tools are produced initially (CAVLC, I-slices), matching the reference's
``WEBRTC_ENCODER`` default envelope of constrained-baseline H.264
(README.md:19-21).
"""

from __future__ import annotations

from .bitwriter import BitWriter


# ---------------------------------------------------------------------------
# Exp-Golomb
# ---------------------------------------------------------------------------

def write_ue(bw: BitWriter, v: int) -> None:
    """Unsigned Exp-Golomb code."""
    assert v >= 0
    code = v + 1
    nbits = code.bit_length()
    bw.write(0, nbits - 1)
    bw.write(code, nbits)


def write_se(bw: BitWriter, v: int) -> None:
    """Signed Exp-Golomb: 0, 1, -1, 2, -2 ... -> ue(0), ue(1), ue(2) ..."""
    write_ue(bw, 2 * v - 1 if v > 0 else -2 * v)


def rbsp_trailing_bits(bw: BitWriter) -> None:
    bw.write(1, 1)
    bw.pad_to_byte(0)


# ---------------------------------------------------------------------------
# NAL units
# ---------------------------------------------------------------------------

NAL_SLICE = 1
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8

START_CODE = b"\x00\x00\x00\x01"


def emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 0x0000 followed by 0x00/01/02/03 (spec §7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    """Annex-B NAL unit: start code + header byte + EPB-escaped RBSP."""
    from ..native import lib as native_lib
    header = bytes([(ref_idc << 5) | nal_type])
    if len(rbsp) > 4096 and native_lib.available():
        escaped = native_lib.emulation_prevention(rbsp)
    else:
        escaped = emulation_prevention(rbsp)
    return START_CODE + header + escaped


# ---------------------------------------------------------------------------
# Parameter sets (baseline profile)
# ---------------------------------------------------------------------------

def sps_rbsp(width: int, height: int, level_idc: int = 42,
             profile: str = "baseline") -> bytes:
    """Sequence parameter set for progressive 4:2:0.

    ``profile``: "baseline" (CAVLC streams) or "main" (required for
    CABAC, spec A.2.2 — baseline excludes entropy_coding_mode_flag=1).
    Frame cropping carries non-multiple-of-16 dimensions; POC type 2 keeps
    the slice header free of POC syntax for an I/P-only stream.
    """
    mb_w = (width + 15) // 16
    mb_h = (height + 15) // 16
    crop_r = mb_w * 16 - width      # luma samples to crop on the right
    crop_b = mb_h * 16 - height     # and bottom
    bw = BitWriter()
    if profile == "main":
        bw.write(77, 8)              # profile_idc: main
        bw.write(0b01000000, 8)      # constraint_set1 (main), reserved 0
    else:
        bw.write(66, 8)              # profile_idc: baseline
        bw.write(0b11000000, 8)      # constraint_set0+1, reserved zeros
    bw.write(level_idc, 8)
    write_ue(bw, 0)                  # seq_parameter_set_id
    write_ue(bw, 0)                  # log2_max_frame_num_minus4 -> 4 bits
    write_ue(bw, 2)                  # pic_order_cnt_type
    write_ue(bw, 1)                  # max_num_ref_frames
    bw.write(0, 1)                   # gaps_in_frame_num_value_allowed
    write_ue(bw, mb_w - 1)           # pic_width_in_mbs_minus1
    write_ue(bw, mb_h - 1)           # pic_height_in_map_units_minus1
    bw.write(1, 1)                   # frame_mbs_only_flag
    bw.write(1, 1)                   # direct_8x8_inference_flag
    if crop_r or crop_b:
        bw.write(1, 1)               # frame_cropping_flag
        write_ue(bw, 0)              # left (chroma units: /2)
        write_ue(bw, crop_r // 2)    # right
        write_ue(bw, 0)              # top
        write_ue(bw, crop_b // 2)    # bottom
    else:
        bw.write(0, 1)
    bw.write(0, 1)                   # vui_parameters_present_flag
    rbsp_trailing_bits(bw)
    return bw.getvalue()


def pps_rbsp(init_qp: int = 26, cabac: bool = False) -> bytes:
    """Picture parameter set: CAVLC or CABAC entropy coding.

    deblocking_filter_control_present_flag=1 lets every slice header turn
    the loop filter off (disable_deblocking_filter_idc=1), which our
    parallel closed-loop reconstruction requires to stay bit-exact.
    """
    bw = BitWriter()
    write_ue(bw, 0)                  # pic_parameter_set_id
    write_ue(bw, 0)                  # seq_parameter_set_id
    bw.write(1 if cabac else 0, 1)   # entropy_coding_mode_flag
    bw.write(0, 1)                   # bottom_field_pic_order_in_frame_present
    write_ue(bw, 0)                  # num_slice_groups_minus1
    write_ue(bw, 0)                  # num_ref_idx_l0_default_active_minus1
    write_ue(bw, 0)                  # num_ref_idx_l1_default_active_minus1
    bw.write(0, 1)                   # weighted_pred_flag
    bw.write(0, 2)                   # weighted_bipred_idc
    write_se(bw, init_qp - 26)       # pic_init_qp_minus26
    write_se(bw, 0)                  # pic_init_qs_minus26
    write_se(bw, 0)                  # chroma_qp_index_offset
    bw.write(1, 1)                   # deblocking_filter_control_present_flag
    bw.write(0, 1)                   # constrained_intra_pred_flag
    bw.write(0, 1)                   # redundant_pic_cnt_present_flag
    rbsp_trailing_bits(bw)
    return bw.getvalue()


def slice_header(bw: BitWriter, *, first_mb: int, slice_type: int,
                 frame_num: int, idr: bool, idr_pic_id: int = 0,
                 qp_delta: int = 0, deblocking_idc: int = 1,
                 cabac: bool = False, cabac_init_idc: int = 0) -> None:
    """Write a slice header (I=7 / P=5 all-slices-same-type variants).

    Assumes the SPS/PPS above: frame_num is 4 bits, POC type 2,
    deblocking control present.  With ``cabac`` (PPS
    entropy_coding_mode_flag=1), P slices carry cabac_init_idc
    (spec 7.3.3) — the caller appends cabac_alignment_one_bit padding
    before the arithmetic-coded slice data.
    """
    write_ue(bw, first_mb)           # first_mb_in_slice
    write_ue(bw, slice_type)         # 7 = I (all), 5 = P (all)
    write_ue(bw, 0)                  # pic_parameter_set_id
    bw.write(frame_num & 0xF, 4)     # frame_num
    if idr:
        write_ue(bw, idr_pic_id)     # idr_pic_id
    if slice_type % 5 == 0:          # P slice
        bw.write(0, 1)               # num_ref_idx_active_override_flag
        bw.write(0, 1)               # ref_pic_list_modification_flag_l0
    if idr:
        bw.write(0, 1)               # no_output_of_prior_pics_flag
        bw.write(0, 1)               # long_term_reference_flag
    elif slice_type % 5 == 0:
        bw.write(0, 1)               # adaptive_ref_pic_marking_mode_flag
    if cabac and slice_type % 5 != 2 and slice_type % 5 != 4:
        write_ue(bw, cabac_init_idc)  # cabac_init_idc (P slices)
    write_se(bw, qp_delta)           # slice_qp_delta
    write_ue(bw, deblocking_idc)     # disable_deblocking_filter_idc
    if deblocking_idc != 1:
        write_se(bw, 0)              # slice_alpha_c0_offset_div2
        write_se(bw, 0)              # slice_beta_offset_div2
