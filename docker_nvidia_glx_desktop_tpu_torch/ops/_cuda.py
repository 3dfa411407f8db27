"""Build and call the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into ``build/lib<name>.so`` beside the package (git-ignored)
and loaded with ``ctypes``.  Every entry point has a plain C interface:
device pointers, then ints, then the CUDA stream, and returns a
``cudaError_t`` (0 = launched).  Nothing is built when the package is
imported: a machine without ``nvcc`` or a card imports and tests the
plain PyTorch versions only.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
KERNEL_SOURCES = ("intra", "cavlc", "pack", "content", "inter", "deblock",
                  "color", "levelpack", "cabac", "damage", "aq", "jpeg",
                  "probe", "spatial", "devloop")

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}


class Counter:
    """The launch count of a kernel form whose wrapper already counts
    another form (``wrapper.hq``: the tune=hq instantiation)."""

    def __init__(self):
        self.launches = 0

_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD, f"lib{name}.so"))


def _stale(name: str) -> bool:
    """No library yet, or one older than any source (the header too)."""
    out = _paths(name)[1]
    return not os.path.exists(out) or os.path.getmtime(out) < max(
        os.path.getmtime(os.path.join(CSRC, f)) for f in os.listdir(CSRC))


def build(names=KERNEL_SOURCES, verbose: bool = False) -> dict:
    """Compile the stale sources, one ``nvcc`` per source, all at once.
    Returns {name: compiler output}; raises if any build fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, out = _paths(name)
        cmd = [nvcc()] + _NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", out + ".tmp", src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    logs, failed = {}, []
    for name, (p, out) in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(out + ".tmp", out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(_paths(name)[1])
            lib.dngd_error_string.restype = ctypes.c_char_p
            lib.dngd_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


_entries: dict = {}


def _entry(lib_name: str, fn_name: str, nt: int, ni: int):
    """``fn_name`` of ``lib<lib_name>.so`` as a ctypes function of ``nt``
    pointers, ``ni`` ints and the stream, built once: a launch then pays
    no signature set-up (a frame's host time is mostly its launches')."""
    key = (lib_name, fn_name, nt, ni)
    got = _entries.get(key)
    if got is None:
        lib = library(lib_name)
        fn = lib[fn_name]               # a function object of its own
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * nt + [ctypes.c_int] * ni
                       + [ctypes.c_void_p])
        got = _entries[key] = (lib, fn)
    return got


def _stream(index: int) -> int:
    """The current stream of device ``index`` as its raw handle."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(lib_name: str, fn_name: str, tensors, ints, device) -> None:
    """Call ``fn_name(ptrs..., ints..., stream)`` of ``lib<lib_name>.so``
    on the current stream of ``device``; raises on a non-zero return.
    A ``None`` tensor passes a null pointer (an absent optional input)."""
    cur = torch.cuda.current_device()
    index = cur if device.index is None else device.index
    for t in tensors:
        if t is not None and (t.get_device() != index
                              or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: every tensor must be contiguous "
                             f"on {device}")
    lib, fn = _entry(lib_name, fn_name, len(tensors), len(ints))
    args = ([None if t is None else t.data_ptr() for t in tensors]
            + [int(i) for i in ints] + [_stream(index)])
    if index == cur:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({lib.dngd_error_string(err).decode()})")
