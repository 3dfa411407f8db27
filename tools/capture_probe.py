"""Does a CUDA graph capture survive the cycle collector?

A dead CUDA graph held only by a reference cycle (as a dropped encoder's
``devloop.ChunkStep`` and its captured instances are) is destroyed when
the collector next runs.  This script leaves such a graph waiting, then
captures a small body that trips the collector's automatic runs, twice:
through plain ``torch.cuda.graph`` and through the port's
``devloop.graph_capture``.  It prints one line a capture, ``OK`` or
``FAILED`` with the CUDA error, and the card's name and power limit.

    python3 tools/capture_probe.py     (on a machine with a CUDA card)
"""

import gc
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from docker_nvidia_glx_desktop_tpu_torch.ops import devloop  # noqa: E402


class Cycle:
    def __init__(self, payload):
        self.payload, self.me = payload, self


def leave_dead_graph(dev) -> None:
    x = torch.zeros(1024, device=dev)
    g, out = devloop.capture_graph(dev, lambda: x + 1)[:2]
    g.replay()
    torch.cuda.synchronize()
    Cycle((g, x, out))


def collect_automatically() -> None:
    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(1000):
            Cycle(None)
    finally:
        gc.set_threshold(*old)


def attempt(name: str, ctx, dev) -> bool:
    gc.collect()
    leave_dead_graph(dev)
    a = torch.ones(4096, device=dev)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with ctx(g):
            b = a * 2
            collect_automatically()
        g.replay()
        torch.cuda.synchronize()
        ok = torch.equal(b, a * 2)
        print(f"{name}: capture {'OK' if ok else 'WRONG'}")
        return ok
    except Exception as e:              # the CUDA error is the finding
        print(f"{name}: capture FAILED: {type(e).__name__}: "
              f"{str(e).splitlines()[0]}")
        return False


def main() -> int:
    if not torch.cuda.is_available():
        print("capture_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    attempt("torch.cuda.graph", torch.cuda.graph, dev)
    return 0 if attempt("devloop.graph_capture", devloop.graph_capture,
                        dev) else 1


if __name__ == "__main__":
    sys.exit(main())
