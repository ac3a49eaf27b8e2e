"""Time the Cholesky sampler's scan kernel (``csrc/cholesky_scan.cu``) for
one draw at several widths R on each route, to split its time an item into
a part that grows with R^2 and one that does not.

    PYTHONPATH=src python tools/cholesky_scan_times.py [--m 32768]
        [--r 8 128 200 208 224]

Routes: "blocked" (a block of b = 32 items at a time, R <= 208) and
"resident" (b = 1, one item at a time, R <= 224), each run at every R it
takes, on the same inputs.  Rows are normal draws from ``--seed`` scaled
to E|Y| ~ 10 against W = I, one draw (N = 1, one SM); the time does not
depend on the data.  Prints one JSON line: the card's name and power
limit as ``nvidia-smi`` gives them and, per R and route (with its b), the
mean CUDA-event time of ``--reps`` warm calls in ms and in ns an item.
Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=1 << 15)
    ap.add_argument("--r", type=int, nargs="+",
                    default=[8, 128, 200, 208, 224])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from repro_torch.kernels.cholesky_scan import ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    block = {"blocked": ops.BLOCK, "resident": 1}
    times = {}
    for r in args.r:
        z = torch.randn((args.m, r), generator=gen, device="cuda")
        z *= (10.0 / args.m / r) ** 0.5
        w = torch.eye(r, device="cuda")
        u = torch.rand((1, args.m), generator=gen, device="cuda")
        for route in ops.ROUTES:
            if route == "blocked" and r > ops.BLOCKED_MAX_R:
                continue
            ms = cuda_ms(lambda: ops._launch(route, z, w, u), args.reps)
            times.setdefault(str(r), {})[route] = {
                "b": block[route], "ms": ms, "ns_an_item": ms * 1e6 / args.m}
        times[str(r)]["route"] = ops.route(r)
    print(json.dumps({"card": card, "M": args.m, "N": 1, "reps": args.reps,
                      "by_R": times}))


if __name__ == "__main__":
    main()
