"""Bit packers (K3 for I slices, K7 for P slices): a frame's CAVLC
codeword slots -> one flat buffer of row RBSPs with a metadata header.

Replaces the reference's ``ops/cavlc_device.py`` ``pack_frame`` and the
``ops/bitmerge.py`` hierarchy it runs (``slots_to_words``,
``merge_pieces_dense``, ``merge_pieces_tree``, row compaction, META),
and ``ops/cavlc_p_device.py`` ``pack_p_frame``.
Only the output bytes carry over, not the TPU's scatter-free merge tree:
every codeword's bit offset is a prefix sum of the slot lengths along its
row, and the codeword is OR-ed into the row's words at that offset.  On
the card (``csrc/pack.cu``) a memset and one launch: a CTA per segment of
eight MBs of a row counts its slots, takes its place in the stream from
the segments and rows before it (a look-back through a small state behind
the flat buffers) and writes its words.

The flat buffer is META_WORDS big-endian uint32 words — [0] overflow flag,
[1] total_words, [2:2+R] row bytes, [2+MAX_META_ROWS:...+R] row word
offsets, [META_QP_SUM_WORD] summed per-MB qp (0 under tune=off) — then
the rows' RBSPs, each starting on a 4-byte boundary, capped at
FLAT_CAP_WORDS words.  The overflow flag trips where the reference's
static caps do: a block or the MB syntax above 256 bits, an MB above
2048 bits, or more than FLAT_CAP_WORDS words in all; the caller then
codes the frame on the host.  Past ``META_WORDS*4 + 4*total_words`` the
buffer is zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

BLOCK_CAP_BITS = 256      # reference L1 buffer: 8 words per block
MB_CAP_BITS = 2048        # reference L2 buffer: 64 words per MB
META_WORDS = 1024
MAX_META_ROWS = 510
META_QP_SUM_WORD = 2 + 2 * MAX_META_ROWS          # = 1022 < META_WORDS
FLAT_CAP_WORDS = 1 << 17  # 512 KiB bitstream cap
FLAT_BYTES = 4 * (META_WORDS + FLAT_CAP_WORDS)


def _be_bytes(words: torch.Tensor) -> torch.Tensor:
    """int64 words (< 2^32) -> big-endian uint8 bytes."""
    b = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                     (words >> 8) & 0xFF, words & 0xFF], dim=-1)
    return b.reshape(-1).to(torch.uint8)


def _pack_plain(syn_vals, syn_lens, values, lengths, hdr_vals, hdr_lens,
                run_vals=None, run_lens=None, qp_sum=None):
    """Plain packer of either slice type.  Per row, in stream order: the
    slice header, then per MB its syntax piece and its blocks, then (P
    slices) the trailing skip-run piece, then the rbsp stop bit and the
    alignment zeros.  Slot values are placed at the prefix sum of the
    lengths before them; OR equals ADD because the codewords of a row
    never share a bit."""
    dev = values.device
    nr, nc = syn_vals.shape[:2]
    lengths = lengths.long()
    syn_lens = syn_lens.long()
    hdr_lens = hdr_lens.long()
    if run_vals is None:
        run_vals = torch.zeros(nr, dtype=torch.int64, device=dev)
        run_lens = torch.zeros(nr, dtype=torch.int64, device=dev)
    run_lens = run_lens.long()
    blk_bits = lengths.sum(dim=3)                           # (R, C, B)
    syn_bits = syn_lens.sum(dim=2)                          # (R, C)
    mb_bits = syn_bits + blk_bits.sum(dim=2)
    hdr_bits = hdr_lens.sum(dim=1)
    body_bits = hdr_bits + mb_bits.sum(dim=1) + run_lens
    pad = (8 - ((body_bits + 1) % 8)) % 8
    row_bytes = (body_bits + pad + 1) // 8
    row_words = (row_bytes + 3) // 4
    word_off = row_words.cumsum(dim=0) - row_words
    total_words = row_words.sum()
    overflow = ((blk_bits > BLOCK_CAP_BITS).any()
                | (syn_bits > BLOCK_CAP_BITS).any()
                | (mb_bits > MB_CAP_BITS).any()
                | (total_words > FLAT_CAP_WORDS))

    mb_v = torch.cat([syn_vals.long(), values.long().reshape(nr, nc, -1)],
                     dim=2).reshape(nr, -1)
    mb_l = torch.cat([syn_lens, lengths.reshape(nr, nc, -1)],
                     dim=2).reshape(nr, -1)
    vals = torch.cat([hdr_vals.long(), mb_v, run_vals.long()[:, None],
                      (1 << pad)[:, None]], dim=1) & 0xFFFFFFFF
    lens = torch.cat([hdr_lens, mb_l, run_lens[:, None], (pad + 1)[:, None]],
                     dim=1)
    pos = lens.cumsum(dim=1) - lens + 32 * word_off[:, None]
    live = lens > 0
    pos, lens, vals = pos[live], lens[live], vals[live]
    w = pos >> 5
    end = (pos & 31) + lens
    hi = torch.where(end > 32, vals >> (end - 32).clamp(min=0),
                     (vals << (32 - end).clamp(min=0)) & 0xFFFFFFFF)
    lo = torch.where(end > 32, (vals << (64 - end).clamp(max=63)) & 0xFFFFFFFF, 0)
    words = torch.zeros(FLAT_CAP_WORDS + 1, dtype=torch.int64, device=dev)
    for idx, part in ((w, hi), (w + 1, lo)):
        keep = idx < FLAT_CAP_WORDS
        words.index_add_(0, idx[keep], part[keep])

    meta = torch.zeros(META_WORDS, dtype=torch.int64, device=dev)
    meta[0] = overflow.long()
    meta[1] = total_words
    meta[2:2 + nr] = row_bytes
    meta[2 + MAX_META_ROWS:2 + MAX_META_ROWS + nr] = word_off
    if qp_sum is not None:
        meta[META_QP_SUM_WORD] = qp_sum.reshape(-1)[0].long() & 0xFFFFFFFF
    return _be_bytes(torch.cat([meta, words[:FLAT_CAP_WORDS]]))


def pack_frame_plain(values, lengths, syn_vals, syn_lens, hdr_vals, hdr_lens,
                     qp_sum=None):
    """Plain PyTorch version of K3 (I slices)."""
    return _pack_plain(syn_vals, syn_lens, values, lengths, hdr_vals,
                       hdr_lens, qp_sum=qp_sum)


def pack_p_frame_plain(values, lengths, mbh_vals, mbh_lens, run_vals,
                       run_lens, hdr_vals, hdr_lens, qp_sum=None):
    """Plain PyTorch version of K7 (P slices)."""
    return _pack_plain(mbh_vals, mbh_lens, values, lengths, hdr_vals,
                       hdr_lens, run_vals, run_lens, qp_sum)


@functools.lru_cache(maxsize=None)
def _buffer_bytes(nr: int, nc: int, ns: int) -> int:
    """The packer's buffer: ``ns`` flats, then its look-back state, as
    ``csrc/pack.cu``'s ``pack_buffer_bytes`` sizes it (the launch zeroes
    all of it)."""
    fn = _cuda.library("pack").pack_buffer_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return int(fn(nr, nc, ns))


def _flat_buffer(lead: tuple, nr: int, nc: int, dev):
    """(buffer, the flats as its (*lead, FLAT_BYTES) view)."""
    ns = lead[0] if lead else 1
    buf = torch.empty(_buffer_bytes(nr, nc, ns), dtype=torch.uint8, device=dev)
    return buf, buf[:ns * FLAT_BYTES].view(lead + (FLAT_BYTES,))


def _sessions(t, base_dims: int) -> tuple:
    """The leading session axis of a stacked slot tensor: () or (S,)."""
    lead = t.dim() - base_dims
    if lead not in (0, 1):
        raise ValueError(f"slots of {t.dim()} dims: want {base_dims} or "
                         f"{base_dims + 1} (a leading session axis)")
    return tuple(t.shape[:lead])


def _plain_sessions(fn, lead, stacked, hdr, qp_sum):
    """A plain packer session by session: ``stacked`` tensors carry the
    session axis, the header slots ``hdr`` one where they are per session
    (else they are shared), the qp sums one each."""
    per = hdr[0].dim() == 3
    return torch.stack([fn(*(t[i] for t in stacked),
                           *(h[i] if per else h for h in hdr),
                           qp_sum=None if qp_sum is None else qp_sum[i:i + 1])
                        for i in range(lead[0])])


def _hdr_shape(hdr_vals, lead, nr) -> tuple:
    """The header slots' shape: shared (R, 3), or per session (S, R, 3)."""
    return (lead + (nr, 3)) if lead and hdr_vals.dim() == 3 else (nr, 3)


def _check_slots(want: dict, dev) -> None:
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name}: want {shape} int32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_qp_sum(qp_sum, dev, n: int = 1) -> None:
    if qp_sum is not None and (qp_sum.dtype != torch.int32
                               or qp_sum.numel() != n
                               or qp_sum.device != dev):
        raise ValueError(f"qp_sum must be {n} int32 on the slots' device")


def pack_frame(values, lengths, syn_vals, syn_lens, hdr_vals, hdr_lens,
               qp_sum=None):
    """Codeword slots -> flat uint8 buffer of FLAT_BYTES (see module doc).

    values/lengths (R, C, 27, 34), syn_vals/syn_lens (R, C, 20), hdr_vals/
    hdr_lens (R, 3), all int32 (values are the uint32 bit patterns);
    ``qp_sum`` (tune=hq: one int32 on the card) the META_QP_SUM_WORD.  CUDA
    tensors launch the packer (a memset and one launch, see the module
    doc); CPU tensors run the plain version.

    Slots with a leading session axis (S, R, C, ...) pack S sessions'
    frames in one launch (a session's segments after the previous
    session's): flat (S, FLAT_BYTES), each session's overflow flag and
    caps its own, under one set of header slots (R, 3) or one per session
    (S, R, 3) — the spatial shards' rows, each shard's first_mb_in_slice
    its own — and with ``qp_sum`` (S,) each session's META word."""
    lead = _sessions(syn_vals, 3)
    nr, nc = syn_vals.shape[len(lead):len(lead) + 2]
    dev = values.device
    hs = _hdr_shape(hdr_vals, lead, nr)
    want = {"values": (values, lead + (nr, nc, 27, 34)),
            "lengths": (lengths, lead + (nr, nc, 27, 34)),
            "syn_vals": (syn_vals, lead + (nr, nc, 20)),
            "syn_lens": (syn_lens, lead + (nr, nc, 20)),
            "hdr_vals": (hdr_vals, hs), "hdr_lens": (hdr_lens, hs)}
    _check_slots(want, dev)
    _check_qp_sum(qp_sum, dev, lead[0] if lead else 1)
    if nr > MAX_META_ROWS:
        raise ValueError(f"{nr} MB rows exceed the metadata header's "
                         f"{MAX_META_ROWS}")
    if dev.type == "cpu":
        if lead:
            return _plain_sessions(pack_frame_plain, lead,
                                   (values, lengths, syn_vals, syn_lens),
                                   (hdr_vals, hdr_lens), qp_sum)
        return pack_frame_plain(values, lengths, syn_vals, syn_lens,
                                hdr_vals, hdr_lens, qp_sum)
    buf, flat = _flat_buffer(lead, nr, nc, dev)
    _cuda.launch("pack", "pack_frame_launch",
                 [values, lengths, syn_vals, syn_lens, hdr_vals, hdr_lens,
                  buf, qp_sum],
                 [nr, nc, lead[0] if lead else 1, len(hs) == 3], dev)
    if qp_sum is None:
        pack_frame.launches += 1
    else:
        pack_frame.hq.launches += 1
    return flat


pack_frame.launches = 0
pack_frame.hq = _cuda.Counter()          # with the qp sum (tune=hq)


def pack_p_frame(values, lengths, mbh_vals, mbh_lens, run_vals, run_lens,
                 hdr_vals, hdr_lens, qp_sum=None):
    """A P frame's slots -> flat uint8 buffer of FLAT_BYTES, the layout
    of :func:`pack_frame`.

    values/lengths (R, C, 26, 34) block slots — (R, C, 27, 34) with the
    I16-in-P DC block first (tune=hq, ``p_intra``) —, mbh_vals/mbh_lens
    (R, C, 7) MB header slots, run_vals/run_lens (R,) the trailing skip
    run of each row, hdr_vals/hdr_lens (R, 3) slice headers, all int32;
    ``qp_sum`` as :func:`pack_frame`'s.  The overflow caps are K3's, with
    the MB header in place of the MB syntax piece.  CUDA tensors launch
    the packer; CPU tensors run the plain version.  A leading session
    axis on every slot tensor packs S sessions in one launch, the header
    slots and qp sums as :func:`pack_frame`'s."""
    lead = _sessions(mbh_vals, 3)
    nr, nc = mbh_vals.shape[len(lead):len(lead) + 2]
    dev = values.device
    nb = values.shape[len(lead) + 2] if values.dim() == len(lead) + 4 else 0
    if nb not in (26, 27):
        raise ValueError("values must be (R, C, 26 or 27, 34)")
    _check_qp_sum(qp_sum, dev, lead[0] if lead else 1)
    hs = _hdr_shape(hdr_vals, lead, nr)
    _check_slots({"values": (values, lead + (nr, nc, nb, 34)),
                  "lengths": (lengths, lead + (nr, nc, nb, 34)),
                  "mbh_vals": (mbh_vals, lead + (nr, nc, 7)),
                  "mbh_lens": (mbh_lens, lead + (nr, nc, 7)),
                  "run_vals": (run_vals, lead + (nr,)),
                  "run_lens": (run_lens, lead + (nr,)),
                  "hdr_vals": (hdr_vals, hs),
                  "hdr_lens": (hdr_lens, hs)}, dev)
    if nr > MAX_META_ROWS:
        raise ValueError(f"{nr} MB rows exceed the metadata header's "
                         f"{MAX_META_ROWS}")
    if dev.type == "cpu":
        if lead:
            return _plain_sessions(
                pack_p_frame_plain, lead,
                (values, lengths, mbh_vals, mbh_lens, run_vals, run_lens),
                (hdr_vals, hdr_lens), qp_sum)
        return pack_p_frame_plain(values, lengths, mbh_vals, mbh_lens,
                                  run_vals, run_lens, hdr_vals, hdr_lens,
                                  qp_sum)
    buf, flat = _flat_buffer(lead, nr, nc, dev)
    _cuda.launch("pack", "pack_p_frame_launch",
                 [values, lengths, mbh_vals, mbh_lens, run_vals, run_lens,
                  hdr_vals, hdr_lens, buf, qp_sum],
                 [nr, nc, nb, lead[0] if lead else 1, len(hs) == 3], dev)
    if nb == 27 or qp_sum is not None:
        pack_p_frame.hq.launches += 1
    else:
        pack_p_frame.launches += 1
    return flat


pack_p_frame.launches = 0
pack_p_frame.hq = _cuda.Counter()        # 27 blocks or a qp sum (tune=hq)
