"""Build-on-demand loader of the port's native host library.

Compiles ``cabac.cpp``, ``levelpack.cpp``, ``entropy.cpp`` and
``cavlc.cpp`` of this directory with ``g++`` into one shared object in
the package's
git-ignored ``build/`` (named by a hash of the sources and flags, so a
changed source builds anew), then exposes ctypes bindings with the
reference's signatures and ABI-version checks (``docker_nvidia_glx_desktop_tpu/
native/lib.py``).  Nothing is built when the module is imported.

A failed build or load raises: the CABAC, CAVLC and JPEG coders of the
port have no quiet Python fallback (the pure-Python coders of
``bitstream/`` run only when a caller asks for them, as the tests do).  Only the EPB escaper of
``bitstream/h264.nal_unit`` asks :func:`available` and keeps the Python
escaper where the library cannot be built, as the reference does; the
bytes are the same.

The X capture shim ``xcapture.cpp`` builds apart from that library, with
``-lX11 -lXext`` (:func:`open_xcapture`), and yields None where the X
headers are missing.

``calls`` counts the native entry points that ran to a good end (a
coder call that overran its output cap is not counted), so a caller can
show that the native coder, and not a Python fallback, coded its
frames.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_SRC_DIR), "build")
SOURCES = ("cabac.cpp", "levelpack.cpp", "entropy.cpp", "cavlc.cpp")
# each source's ABI probe and the version this loader binds
_ABI = {"tpudesktop_entropy_abi_version": 2,
        "tpudesktop_cabac_abi_version": 1,
        "tpudesktop_levelpack_abi_version": 1,
        "tpudesktop_cavlc_abi_version": 1}
# no -march=native: a build/ carried to another host must still load
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB = None
_ERROR = None
calls = collections.Counter()
_CALLS_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _CALLS_LOCK:
        calls[name] += 1


def _so_path() -> str:
    tag = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES:
        tag.update(name.encode())
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            tag.update(f.read())
    return os.path.join(BUILD, f"libdngd_native_{tag.hexdigest()[:16]}.so")


def _build() -> str:
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    # a private temp name renamed into place: a crashed or concurrent
    # build never leaves a truncated library at the final path
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = (["g++", *_FLAGS, "-o", tmp]
           + [os.path.join(_SRC_DIR, s) for s in SOURCES])
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native library build failed: {e}") from e
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("native library build failed:\n" + p.stderr)
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    for probe, version in _ABI.items():
        fn = getattr(lib, probe)
        fn.restype = ctypes.c_int32
        if fn() != version:
            raise RuntimeError(f"native library ABI mismatch ({probe})")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    tables = [i8p, u8p, u8p, u8p]
    lib.h264_emulation_prevention.argtypes = [u8p, i64, u8p, i64]
    lib.h264_emulation_prevention.restype = i64
    lib.h264_cabac_intra_slices.argtypes = (
        [i32p] * 6 + [i32p, u8p, i32p, i32p] + [i64, i64, i32] + tables
        + [u8p, i64p, i64])
    lib.h264_cabac_intra_slices.restype = i64
    lib.h264_cabac_p_slices.argtypes = (
        [i32p] * 6 + [i64, i64, i32] + tables + [u8p, i64p, i64])
    lib.h264_cabac_p_slices.restype = i64
    lib.h264_cabac_engine_rows.argtypes = (
        [u32p, i64p, i64p, i64, i32] + tables + [u8p, i64p, i64])
    lib.h264_cabac_engine_rows.restype = i64
    lib.level_unpack_rows.argtypes = [u32p, i64p, i64, i64, i32p]
    lib.level_unpack_rows.restype = None
    lib.h264_encode_intra_picture.argtypes = [i32p] * 6 + [i64, i64, i32, i32,
                                                           u8p, i64]
    lib.h264_encode_intra_picture.restype = i64
    lib.jpeg_component_histogram.argtypes = [i32p, i64, i64p, i64p]
    lib.jpeg_component_histogram.restype = None
    lib.jpeg_encode_scan.argtypes = [i32p, i32p, i32p, i64] + [u32p, u8p] * 4 \
        + [u8p, i64]
    lib.jpeg_encode_scan.restype = i64


def get_lib() -> ctypes.CDLL:
    """The built library; raises RuntimeError if it cannot be built or
    loaded (the first failure is remembered)."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is None and _ERROR is None:
            try:
                lib = ctypes.CDLL(_build())
                _bind(lib)
                _LIB = lib
            except (OSError, RuntimeError, AttributeError) as e:
                _ERROR = RuntimeError(f"native library unavailable: {e}")
        if _ERROR is not None:
            raise _ERROR
        return _LIB


def available() -> bool:
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def cabac_slices(symbol: str, arrays, nr: int, nc: int, qp: int, tables,
                 out: np.ndarray, lens: np.ndarray, cap: int) -> int:
    """Run ``h264_cabac_intra_slices`` or ``h264_cabac_p_slices``: one
    slice payload per MB row at ``out[row*cap:]``; returns the C code
    (0 = done, -1 = a row overran ``cap``)."""
    fn = getattr(get_lib(), symbol)
    rc = int(fn(*arrays, nr, nc, int(qp), *tables, out, lens, cap))
    if rc == 0:
        _count(symbol)
    return rc


def cabac_engine_rows(payload: np.ndarray, row_off: np.ndarray,
                      row_bits: np.ndarray, rows: int, qp: int,
                      ctx_init, rng, tmps, tlps, cap: int):
    """Run the arithmetic engine over per-row record streams.

    Returns the per-row slice payload bytes, or the int failure code:
    -1 = output cap overflow (caller may retry with a larger cap),
    -2 = malformed record stream (retrying cannot help)."""
    lib = get_lib()
    out = np.empty(rows * cap, np.uint8)
    lens = np.zeros(rows, np.int64)
    rc = lib.h264_cabac_engine_rows(
        np.ascontiguousarray(payload, np.uint32),
        np.ascontiguousarray(row_off, np.int64),
        np.ascontiguousarray(row_bits, np.int64),
        rows, int(qp), ctx_init, rng, tmps, tlps, out, lens, cap)
    if rc != 0:
        return int(rc)
    _count("h264_cabac_engine_rows")
    return [out[r * cap:r * cap + lens[r]].tobytes() for r in range(rows)]


def level_unpack(payload: np.ndarray, row_off: np.ndarray, rows: int,
                 slots_per_row: int) -> np.ndarray:
    """Threaded C decode of the level-pack transport (rows parallel)."""
    lib = get_lib()
    _count("level_unpack_rows")
    out = np.empty(rows * slots_per_row, np.int32)
    lib.level_unpack_rows(np.ascontiguousarray(payload, np.uint32),
                          np.ascontiguousarray(row_off, np.int64),
                          rows, slots_per_row, out)
    return out


def has_cavlc() -> bool:
    """The native CAVLC coder is there: the library built (else this
    raises, as :func:`get_lib` does; the reference answers False and
    serves Python)."""
    return hasattr(get_lib(), "h264_encode_intra_picture")


def h264_encode_intra_picture(levels: dict, *, frame_num: int,
                              idr_pic_id: int) -> bytes:
    """Every row slice of an I_16x16 picture (the intra core's levels,
    DC prediction, the slice qp, no deblocking) as Annex-B NAL units,
    coded by the C CAVLC coder on a thread per row."""
    lib = get_lib()
    c = lambda k: np.ascontiguousarray(levels[k], np.int32)
    luma_dc = c("luma_dc")
    nr, nc = luma_dc.shape[:2]
    cap = max(1 << 16, int(nr * nc) * 800)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.h264_encode_intra_picture(
            luma_dc, c("luma_ac"), c("cb_dc"), c("cb_ac"), c("cr_dc"),
            c("cr_ac"), nr, nc, frame_num, idr_pic_id, out, cap)
        if n >= 0:
            _count("h264_encode_intra_picture")
            return out[:n].tobytes()
        cap *= 2


def jpeg_histograms(y_flat: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """DC/AC symbol histograms per table (0 luma, 1 chroma) of zigzagged
    (n, 64) blocks, via C."""
    lib = get_lib()
    dc_hist = [np.zeros(17, np.int64), np.zeros(17, np.int64)]
    ac_hist = [np.zeros(256, np.int64), np.zeros(256, np.int64)]
    lib.jpeg_component_histogram(np.ascontiguousarray(y_flat, np.int32),
                                 y_flat.shape[0], dc_hist[0], ac_hist[0])
    for comp in (cb, cr):
        lib.jpeg_component_histogram(np.ascontiguousarray(comp, np.int32),
                                     comp.shape[0], dc_hist[1], ac_hist[1])
    _count("jpeg_component_histogram")
    return dc_hist, ac_hist


def _table_arrays(table):
    """HuffmanTable -> dense (codes uint32[256], lens uint8[256])."""
    codes = np.zeros(256, np.uint32)
    lens = np.zeros(256, np.uint8)
    n = len(table.codes)
    codes[:n] = table.codes.astype(np.uint32)
    lens[:n] = table.lengths.astype(np.uint8)
    return codes, lens


def jpeg_encode_scan(y_flat, cb, cr, tables) -> bytes:
    """The interleaved 4:2:0 scan (4 luma blocks, Cb, Cr per MCU), byte
    stuffed, via C; ``tables`` = (dc_l, ac_l, dc_c, ac_c)."""
    lib = get_lib()
    nmcu = cb.shape[0]
    args = []
    for t in tables:
        args.extend(_table_arrays(t))
    cap = max(1 << 16, int(y_flat.size + cb.size + cr.size) * 4)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode_scan(np.ascontiguousarray(y_flat, np.int32),
                                 np.ascontiguousarray(cb, np.int32),
                                 np.ascontiguousarray(cr, np.int32),
                                 nmcu, *args, out, cap)
        if n >= 0:
            _count("jpeg_encode_scan")
            return out[:n].tobytes()
        cap *= 2


def emulation_prevention(rbsp: bytes) -> bytes:
    """H.264 EPB escaping via C."""
    lib = get_lib()
    src = np.frombuffer(rbsp, np.uint8)
    out = np.empty(len(src) * 3 // 2 + 16, np.uint8)
    n = lib.h264_emulation_prevention(src, len(src), out, len(out))
    if n < 0:
        raise RuntimeError("EPB output buffer too small")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# X display capture (needs the X11 and Xext headers and libraries, which only
# the container image has): built apart from the library above, so that a
# host without them still builds the coders.

_XCAP_LIB = None
_XCAP_TRIED = False


class XCapture:
    """Handle over the xcapture.cpp shim: grab the root window as RGB."""

    def __init__(self, lib: ctypes.CDLL, handle):
        self._lib = lib
        self._h = handle
        self._w = lib.xcap_width(handle)
        self._hgt = lib.xcap_height(handle)
        self._buf = np.empty((self._hgt, self._w, 3), np.uint8)

    def size(self):
        return self._w, self._hgt

    def grab(self) -> np.ndarray:
        if self._lib.xcap_grab(self._h, self._buf) != 0:
            raise RuntimeError("XShmGetImage/XGetImage failed")
        return self._buf

    def close(self) -> None:
        if self._h is not None:
            self._lib.xcap_close(self._h)
            self._h = None


def _xcap_lib():
    """The capture shim, built with ``g++ ... -lX11 -lXext`` into
    ``build/`` at first use; None where it cannot be built or loaded."""
    global _XCAP_LIB, _XCAP_TRIED
    with _LOCK:
        if _XCAP_TRIED:
            return _XCAP_LIB
        _XCAP_TRIED = True
        src = os.path.join(_SRC_DIR, "xcapture.cpp")
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(BUILD, f"libdngd_xcap_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                   src, "-lX11", "-lXext"]
            try:
                p = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
            if p.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                return None
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.xcap_open.argtypes = [ctypes.c_char_p]
        lib.xcap_open.restype = ctypes.c_void_p
        lib.xcap_width.argtypes = [ctypes.c_void_p]
        lib.xcap_width.restype = ctypes.c_int
        lib.xcap_height.argtypes = [ctypes.c_void_p]
        lib.xcap_height.restype = ctypes.c_int
        lib.xcap_grab.argtypes = [ctypes.c_void_p, u8p]
        lib.xcap_grab.restype = ctypes.c_int
        lib.xcap_close.argtypes = [ctypes.c_void_p]
        lib.xcap_close.restype = None
        _XCAP_LIB = lib
        return lib


def open_xcapture(display: str = ":0"):
    """Open the X display for capture; None when the shim or the display
    is unavailable (callers then serve the synthetic source)."""
    lib = _xcap_lib()
    if lib is None:
        return None
    handle = lib.xcap_open(display.encode())
    if not handle:
        return None
    return XCapture(lib, handle)
