"""Time ``block_outer_sums`` and ``bilinear_batched`` on the card at the
shapes of ``chip_smoke.py``'s paths, beside their one-call PyTorch
yardsticks.

It times the kernels of whichever ``repro_torch`` comes first on
``PYTHONPATH``, so two trees are compared in one call by running it in
turns, for example (the parent unpacked with ``git archive`` into a
git-ignored directory):

    PYTHONPATH=_ab/parent/src python tools/tree_kernel_times.py --tag parent
    PYTHONPATH=src python tools/tree_kernel_times.py --tag change
    PYTHONPATH=src python tools/tree_kernel_times.py --tag change
    PYTHONPATH=_ab/parent/src python tools/tree_kernel_times.py --tag parent

Each run prints one JSON line: the tag, the card's name and power limit
as ``nvidia-smi`` gives them, and per kernel the mean CUDA-event time of
warm calls through the wrapper (``ms``: host dispatch included, where it
is longer than the kernel), the kernel's own mean device time from
``torch.profiler`` (``device_ms``) and the yardstick's event time in the
same process.  Data are normal draws from ``--seed``; neither kernel's
time depends on them.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name: str, reps: int = 50) -> float:
    """Mean device time of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, from a profiler trace (0 if none showed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if name in evt.key:
            total += float(getattr(evt, "self_device_time_total",
                                   getattr(evt, "self_cuda_time_total", 0.0)))
    return total / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.tree_sum import ops as tree_sum_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"tag": args.tag, "card": smi,
           "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
           "source": tree_sum_ops.__file__}

    # block_outer_sums: the main path's leaf level (2^20 rows of R = 200,
    # blocks of 64)
    n, block, r = 1 << 14, 64, 200
    w = torch.randn((n * block, r), generator=g, device=dev)
    wb = w.view(n, block, r)
    leaf = torch.empty((n, r, r), device=dev)
    tree_sum_ops.block_outer_sums(w, block, out=leaf)
    outer = lambda: tree_sum_ops.block_outer_sums(w, block, out=leaf)  # noqa: E731
    out["block_outer_sums"] = {
        "shape": [n, block, r],
        "ms": cuda_ms(outer, 20),
        "device_ms": device_ms(outer, "block_outer_sums_kernel", 10),
        "library_ms": cuda_ms(lambda: torch.bmm(wb.transpose(1, 2), wb), 10),
        # writing the 2.6 GB leaf level once, nothing read: the stores' floor
        "fill_ms": cuda_ms(lambda: leaf.fill_(1.0), 10)}
    del w, wb, leaf
    torch.cuda.empty_cache()

    # bilinear_batched: the sharded path's leaf scoring (64 lanes of 64
    # rows, R = 200)
    n, b = 64, 64
    z = torch.randn((n, b, r), generator=g, device=dev)
    q = torch.randn((n, r, r), generator=g, device=dev)
    batched = lambda: bilinear_ops.bilinear_batched(z, q)  # noqa: E731
    out["bilinear_batched"] = {
        "shape": [n, b, r],
        "ms": cuda_ms(batched, 200),
        "device_ms": device_ms(batched, "bilinear_batched_kernel"),
        "library_ms": cuda_ms(lambda: (torch.bmm(z, q) * z).sum(-1), 200)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
