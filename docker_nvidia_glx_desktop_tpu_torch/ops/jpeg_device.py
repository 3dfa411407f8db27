"""The baseline JPEG encoder's device programs: the transform (K16a), the
symbol histograms (K16b) and the bit pack (K16c), over a session axis and
a restart-strip axis.

Replaces the reference's ``models/mjpeg.py`` ``_transform_stage`` and
``ops/jpeg_device.py`` (``jpeg_analyze``, ``jpeg_pack``; the session
batch of ``parallel/batch.py`` runs the same three with a mesh).  Each
wrapper launches its kernel of ``csrc/jpeg.cu`` for CUDA tensors and runs
its plain PyTorch version (``*_plain``, beside it) for CPU tensors.

Layouts, S sessions of ``nmcu`` MCUs each:

- levels: ``y (S, nmcu, 4, 64)`` (Y00 Y01 Y10 Y11), ``cb``, ``cr (S,
  nmcu, 64)`` int32, zigzagged, MCUs in raster order;
- ``nx`` restart strips split each session's MCUs into equal runs of
  whole MCU rows; each strip starts its DC predictors at 0 and packs into
  its own buffer, so strips join with RSTn markers;
- histograms: ``(S, 546)`` int32, dc_y 17, ac_y 256, dc_c 17, ac_c 256
  (a session's strips summed);
- tables: ``(1092,)`` int32, the four tables' codes in that symbol order,
  then their lengths (:func:`table_tensor`);
- the pack: ``(S, nx, 4 * shard_words)`` uint8 big-endian scans, only
  the first ``ceil(totals / 8)`` bytes of a strip meaningful, and
  ``totals (S, nx)`` int32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, color, dct, quant, scan

TABLE_SIZES = (17, 256, 17, 256)       # dc_l, ac_l, dc_c, ac_c
HIST_SYMBOLS = sum(TABLE_SIZES)
# A block's worst case: DC code 16 + 11 amplitude bits; 63 AC codes of 16
# + 10; three ZRLs (62 zeros at most); EOB.
MAX_BLOCK_BITS = 27 + 63 * 26 + 3 * 16 + 16


def shard_words(blocks: int) -> int:
    """32-bit words of one strip's buffer: its blocks' worst case."""
    return (blocks * MAX_BLOCK_BITS + 31) // 32 + 1


def split_hists(hist: torch.Tensor):
    """(S, 546) -> (dc_y, ac_y, dc_c, ac_c), each (S, n)."""
    return tuple(torch.split(hist, TABLE_SIZES, dim=-1))


# -- K16a: the transform -----------------------------------------------------

_CONSTS: dict = {}


def _consts(luma_q, chroma_q, device) -> torch.Tensor:
    """K16a's 204 float constants on ``device`` (DCT matrix, colour
    matrix, offsets, the two quant tables), uploaded once per tables."""
    lq = np.asarray(luma_q, np.float32).reshape(64)
    cq = np.asarray(chroma_q, np.float32).reshape(64)
    key = (str(device), lq.tobytes(), cq.tobytes())
    t = _CONSTS.get(key)
    if t is None:
        v = np.concatenate([dct.DCT8.ravel(), color._M_FULL.ravel(),
                            color.OFF_FULL, lq, cq]).astype(np.float32)
        t = _CONSTS[key] = torch.from_numpy(v).to(device)
    return t


def _check_rgbs(rgbs, pad_h, pad_w):
    if rgbs.dtype != torch.uint8 or rgbs.dim() != 4 or rgbs.shape[3] != 3 \
            or not rgbs.shape[0] or not rgbs.is_contiguous():
        raise ValueError("frames must be a contiguous (S, H, W, 3) uint8 "
                         "tensor with S >= 1")
    h, w = rgbs.shape[1:3]
    if pad_h % 16 or pad_w % 16 or pad_h < h or pad_w < w or not (h and w):
        raise ValueError(f"padding ({pad_h}, {pad_w}) must be MCU multiples "
                         f"covering the frame ({h}, {w})")


def jpeg_transform_plain(rgbs, luma_q, chroma_q, pad_h: int, pad_w: int):
    """Plain version of K16a: edge pad, full-range colour and quad mean
    (exact in float64), -128, :func:`dct.dct8x8` (float64 in the kernel's
    order, rounded once to float32), float32 ``round(c / q)``, zigzag."""
    s, h, w = rgbs.shape[:3]
    rows = torch.clamp(torch.arange(pad_h, device=rgbs.device), max=h - 1)
    cols = torch.clamp(torch.arange(pad_w, device=rgbs.device), max=w - 1)
    y, cb, cr = color.rgb_to_yuv420_full(rgbs[:, rows][:, :, cols])

    def levels(plane, q):
        coefs = dct.dct8x8(dct.to_blocks(plane - 128.0, 8, 8))
        return scan.zigzag(quant.jpeg_quantize(coefs, q), 8)

    nh, nw = pad_h // 16, pad_w // 16
    yz = levels(y, luma_q).reshape(s, nh, 2, nw, 2, 64)
    y_zz = yz.permute(0, 1, 3, 2, 4, 5).reshape(s, nh * nw, 4, 64)
    return (y_zz.contiguous(), levels(cb, chroma_q).reshape(s, nh * nw, 64),
            levels(cr, chroma_q).reshape(s, nh * nw, 64))


def jpeg_transform(rgbs: torch.Tensor, luma_q, chroma_q, pad_h: int,
                   pad_w: int):
    """(S, H, W, 3) uint8 frames -> levels ``(y, cb, cr)`` (module
    layout), edge-padded to (pad_h, pad_w)."""
    _check_rgbs(rgbs, pad_h, pad_w)
    if rgbs.device.type == "cpu":
        return jpeg_transform_plain(rgbs, luma_q, chroma_q, pad_h, pad_w)
    s, dev = rgbs.shape[0], rgbs.device
    nmcu = (pad_h // 16) * (pad_w // 16)
    y = torch.empty((s, nmcu, 4, 64), dtype=torch.int32, device=dev)
    cb = torch.empty((s, nmcu, 64), dtype=torch.int32, device=dev)
    cr = torch.empty_like(cb)
    _cuda.launch("jpeg", "jpeg_transform_launch",
                 [rgbs, _consts(luma_q, chroma_q, dev), y, cb, cr],
                 [s, rgbs.shape[1], rgbs.shape[2], pad_h, pad_w], dev)
    jpeg_transform.launches += 1
    return y, cb, cr


jpeg_transform.launches = 0


# -- K16b: symbols and histograms --------------------------------------------

def _bit_length(av: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative integer (0 for 0), exact via frexp."""
    return torch.frexp(av.to(torch.float64)).exponent.to(torch.int32)


def _amplitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """JPEG one's-complement amplitude bits of v (size = bit length)."""
    v = v.to(torch.int64)
    return torch.where(v >= 0, v, v + (1 << size.to(torch.int64)) - 1)


def component_symbols(zz: torch.Tensor, first: torch.Tensor) -> dict:
    """Symbols of one component's blocks.

    zz: (nblk, 64) int32 zigzagged levels in chain order; first: (nblk,)
    bool, True where the DC predictor restarts at 0 (a strip's first
    block).  Returns per-block tensors as the reference's
    ``component_symbols``."""
    zz = zz.to(torch.int32)
    dc = zz[:, 0]
    prev = torch.cat([dc.new_zeros(1), dc[:-1]])
    diff = dc - torch.where(first, 0, prev)
    dc_size = _bit_length(diff.abs())
    ac = zz[:, 1:]
    m = ac != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=zz.device)[None, :]
    nz_pos = torch.where(m, pos, 0)
    last_nz = nz_pos.max(dim=1).values
    cm = torch.cummax(nz_pos, dim=1).values
    prev_nz = torch.cat([cm.new_zeros(zz.shape[0], 1), cm[:, :-1]], dim=1)
    gap = pos - prev_nz - 1
    ac_size = _bit_length(ac.abs())
    return {
        "dc_size": dc_size, "dc_amp": _amplitude(diff, dc_size),
        "mask": m, "sym": torch.where(m, ((gap % 16) << 4) | ac_size, 0),
        "amp": _amplitude(ac, ac_size), "size": ac_size,
        "nzrl": torch.where(m, gap // 16, 0), "eob": last_nz < 63,
    }


def component_histogram(sy: dict):
    """DC (17-bin) and AC (256-bin) int64 histograms of one component."""
    dc = torch.bincount(sy["dc_size"].long(), minlength=17)
    ac = torch.bincount(sy["sym"][sy["mask"]].long(), minlength=256)
    ac[0xF0] += sy["nzrl"].sum()
    ac[0x00] += sy["eob"].sum()
    return dc, ac


def _chains(y, cb, cr, nx: int):
    """Per session: the Y chain (nmcu * 4, 64) and the Cb and Cr chains
    (nmcu, 64), each with its strip-start flags."""
    s, nmcu = cb.shape[:2]
    if nx < 1 or nmcu % nx:
        raise ValueError(f"{nmcu} MCUs do not split into {nx} strips")
    mps = nmcu // nx
    idx = torch.arange(nmcu, device=cb.device)
    first_c = idx % mps == 0
    first_y = torch.zeros(nmcu, 4, dtype=torch.bool, device=cb.device)
    first_y[:, 0] = first_c
    for i in range(s):
        yield (y[i].reshape(-1, 64), first_y.reshape(-1)), \
            (cb[i], first_c), (cr[i], first_c)


def jpeg_analyze_plain(y, cb, cr, nx: int = 1) -> torch.Tensor:
    """Plain version of K16b: (S, 546) int32 histograms."""
    out = []
    for yc, bc, rc in _chains(y, cb, cr, nx):
        dy, ay = component_histogram(component_symbols(*yc))
        db, ab = component_histogram(component_symbols(*bc))
        dr, ar = component_histogram(component_symbols(*rc))
        out.append(torch.cat([dy[:17], ay[:256], (db + dr)[:17],
                              (ab + ar)[:256]]))
    return torch.stack(out).to(torch.int32)


def _check_levels(y, cb, cr, nx):
    s, nmcu = cb.shape[:2]
    if y.shape != (s, nmcu, 4, 64) or cb.shape != (s, nmcu, 64) \
            or cr.shape != cb.shape:
        raise ValueError("levels must be y (S, nmcu, 4, 64), cb and cr "
                         "(S, nmcu, 64)")
    if any(t.dtype != torch.int32 for t in (y, cb, cr)):
        raise ValueError("levels must be int32")
    if nx < 1 or nmcu % nx:
        raise ValueError(f"{nmcu} MCUs do not split into {nx} strips")


def jpeg_analyze(y, cb, cr, nx: int = 1) -> torch.Tensor:
    """Symbol histograms of each session, its ``nx`` strips summed:
    (S, 546) int32 (:func:`split_hists`)."""
    _check_levels(y, cb, cr, nx)
    if cb.device.type == "cpu":
        return jpeg_analyze_plain(y, cb, cr, nx)
    s, nmcu = cb.shape[:2]
    hist = torch.empty((s, HIST_SYMBOLS), dtype=torch.int32, device=cb.device)
    _cuda.launch("jpeg", "jpeg_analyze_launch", [y, cb, cr, hist],
                 [s, nmcu, nx], cb.device)
    jpeg_analyze.launches += 1
    return hist


jpeg_analyze.launches = 0


# -- K16c: the bit pack ------------------------------------------------------

def dense_tables(tables):
    """HuffmanTables (dc_l, ac_l, dc_c, ac_c) -> 8 numpy arrays (codes
    uint32, lengths int32, each padded to 17 or 256 symbols), the
    reference's ``JpegEncoder._dense_table_arrays`` order."""
    out = []
    for t, n in zip(tables, TABLE_SIZES):
        codes = np.zeros(n, np.uint32)
        lens = np.zeros(n, np.int32)
        k = len(t.codes)
        codes[:k] = t.codes.astype(np.uint32)
        lens[:k] = t.lengths.astype(np.int32)
        out.extend([codes, lens])
    return out


def table_tensor(arrays, device) -> torch.Tensor:
    """8 dense arrays (codes, lengths per table) -> the (1092,) int32
    table tensor on ``device``: the four code arrays, then the lengths."""
    codes = np.concatenate([np.asarray(a, np.int64) for a in arrays[0::2]])
    lens = np.concatenate([np.asarray(a, np.int64) for a in arrays[1::2]])
    if codes.shape != (HIST_SYMBOLS,) or lens.shape != (HIST_SYMBOLS,):
        raise ValueError("tables must be 17, 256, 17 and 256 symbols")
    return torch.from_numpy(np.concatenate([codes, lens]).astype(
        np.int32)).to(device)


def component_entries(sy: dict, dc_codes, dc_lens, ac_codes, ac_lens):
    """(value, length) entries of one component, (nblk, 254) int64: DC,
    then per AC position three ZRL slots and the symbol, then EOB."""
    nblk = sy["dc_size"].shape[0]
    dcs = sy["dc_size"].long()
    dc_val = (dc_codes[dcs] << dcs) | sy["dc_amp"]
    dc_len = dc_lens[dcs] + dcs
    zrl_vals = ac_codes[0xF0].expand(nblk, 63, 3)
    zrl_lens = torch.where(
        sy["nzrl"][..., None] > torch.arange(3, device=dcs.device),
        ac_lens[0xF0], 0)
    sym, size = sy["sym"].long(), sy["size"].long()
    s_val = (ac_codes[sym] << size) | sy["amp"]
    s_len = torch.where(sy["mask"], ac_lens[sym] + size, 0)
    ac_vals = torch.cat([zrl_vals, s_val[..., None]], dim=-1)
    ac_lens_ = torch.cat([zrl_lens, s_len[..., None]], dim=-1)
    eob_len = torch.where(sy["eob"], ac_lens[0], 0)
    vals = torch.cat([dc_val[:, None], ac_vals.reshape(nblk, 252),
                      ac_codes[0].expand(nblk, 1)], dim=1)
    lens = torch.cat([dc_len[:, None], ac_lens_.reshape(nblk, 252),
                      eob_len[:, None]], dim=1)
    return vals, lens


def jpeg_pack_plain(y, cb, cr, tables: torch.Tensor, nx: int = 1):
    """Plain version of K16c: each strip's entries in interleave order
    (Y x4, Cb, Cr per MCU) through :func:`bitpack.pack_bits`."""
    from .bitpack import pack_bits

    s, nmcu = cb.shape[:2]
    mps = nmcu // nx
    t = tables.to(torch.int64)
    c, n = t[:HIST_SYMBOLS], t[HIST_SYMBOLS:]
    o = np.cumsum((0,) + TABLE_SIZES)
    tab = [(c[o[i]:o[i + 1]], n[o[i]:o[i + 1]]) for i in range(4)]
    nbytes = 4 * shard_words(mps * 6)
    packed, totals = [], []
    for yc, bc, rc in _chains(y, cb, cr, nx):
        vy, ly = component_entries(component_symbols(*yc), *tab[0], *tab[1])
        parts = [(vy.reshape(nmcu, -1), ly.reshape(nmcu, -1))]
        for comp in (bc, rc):
            parts.append(component_entries(component_symbols(*comp),
                                           *tab[2], *tab[3]))
        vals = torch.cat([p[0] for p in parts], dim=1).reshape(nx, -1)
        lens = torch.cat([p[1] for p in parts], dim=1).reshape(nx, -1)
        for k in range(nx):
            p, tot = pack_bits(vals[k], lens[k], nbytes)
            packed.append(p)
            totals.append(tot)
    return (torch.stack(packed).reshape(s, nx, nbytes),
            torch.stack(totals).reshape(s, nx))


def jpeg_pack(y, cb, cr, tables: torch.Tensor, nx: int = 1):
    """Pack each session's strips with the (1092,) ``tables``: (packed
    (S, nx, nbytes) uint8, totals (S, nx) int32 bits); a strip's bytes
    past ``ceil(total / 8)`` are unspecified."""
    _check_levels(y, cb, cr, nx)
    if tables.shape != (2 * HIST_SYMBOLS,) or tables.dtype != torch.int32:
        raise ValueError("tables must be the (1092,) int32 table tensor")
    if cb.device.type == "cpu":
        return jpeg_pack_plain(y, cb, cr, tables, nx)
    s, nmcu = cb.shape[:2]
    dev = cb.device
    sw = shard_words(nmcu // nx * 6)
    counts = torch.empty((s, nmcu * 6), dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    words = torch.empty((s, nx, sw), dtype=torch.int32, device=dev)
    totals = torch.empty((s, nx), dtype=torch.int32, device=dev)
    _cuda.launch("jpeg", "jpeg_pack_launch",
                 [y, cb, cr, tables, counts, offsets, words, totals],
                 [s, nmcu, nx, sw], dev)
    jpeg_pack.launches += 1
    return words.view(torch.uint8), totals


jpeg_pack.launches = 0


def strip_bytes(packed: torch.Tensor, totals: torch.Tensor):
    """Each strip's meaningful bytes on the host: (S, nx) lists of
    (uint8 numpy prefix, bits) -- one pull of the totals, then one of
    each prefix."""
    tot = totals.cpu().numpy()
    cap = packed.shape[-1] * 8
    if (tot > cap).any():
        raise RuntimeError(f"a packed strip of {int(tot.max())} bits "
                           f"overran its {cap}-bit buffer")
    return [[(packed[i, k, :(int(b) + 7) // 8].cpu().numpy(), int(b))
             for k, b in enumerate(row)] for i, row in enumerate(tot)]
