"""Where the Cholesky scan's blocked route (``csrc/cholesky_scan.cu``,
``blocked::kernel``) spends its time: a copy built with
``-DCHOLESKY_SCAN_CLOCKS``, in which thread 0 of CTA 0 adds each step of
a block (from the barrier before it to the barrier after it) to a clock
counter, run at each ``--r`` on one draw or a wave.

    PYTHONPATH=src python tools/cholesky_scan_parts.py [--m 32768]
        [--r 8 128 200] [--n 1]

The copy goes to ``src/repro_torch/_build/parts/`` (git ignores it),
built with ``_build``'s flags and the macro.  Rows are seeded normal draws
scaled to E|Y| ~ 10 against W = I (the time does not depend on the data).
Prints one JSON line a width: the CUDA-event ms of the call, ns an item,
and each step's clocks a block and share of the block's clocks (stage:
Z into shared memory; products: A and B^T; store_a: A into shared memory;
gram: G = Z_b A and its partials, and the next block's loads issued;
decide_load, decide, decide_store: warp 0 sums G's partials, runs
Gauss-Jordan, writes the decisions and C's pair; a_c: A C and its pairs;
update: B's pair and Q -= (A C) B), then the card's name, power limit
and SM clock.  Needs a CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

STEPS = ("stage", "products", "store_a", "gram", "decide_load", "decide",
         "decide_store", "a_c", "update")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=1 << 15)
    ap.add_argument("--r", type=int, nargs="+", default=[8, 128, 200])
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("cholesky_scan_parts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "cholesky_scan_clocks.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DCHOLESKY_SCAN_CLOCKS", "-I",
         str(_build.CSRC), "-o", str(so),
         str(_build.CSRC / "cholesky_scan.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        print(f"cholesky_scan_parts: nvcc failed:\n{proc.stdout}{proc.stderr}",
              file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    run = lib.cholesky_scan_blocked
    run.argtypes = ([ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p] * 3)
    clocks = lib.cholesky_scan_clocks
    clocks.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * len(STEPS))()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for r in args.r:
        z = torch.randn((args.m, r), generator=gen, device="cuda")
        z *= (10.0 / args.m / r) ** 0.5
        w = torch.eye(r, device="cuda")
        u = torch.rand((args.n, args.m), generator=gen, device="cuda")
        take = torch.empty((args.n, args.m), dtype=torch.bool, device="cuda")
        p = torch.empty((args.n, args.m), device="cuda")

        def call():
            _build.check(run(z.data_ptr(), w.data_ptr(), u.data_ptr(), args.m,
                             r, args.n, take.data_ptr(), p.data_ptr(),
                             torch.cuda.current_stream().cuda_stream),
                         "cholesky_scan_blocked (clocks)")

        call()
        torch.cuda.synchronize()
        _build.check(clocks(buf), "cholesky_scan_clocks")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        _build.check(clocks(buf), "cholesky_scan_clocks")
        ms = start.elapsed_time(end)
        blocks = -(-args.m // 32)
        total = sum(buf)
        print(json.dumps({
            "R": r, "M": args.m, "N": args.n, "ms": ms,
            "ns_an_item": ms * 1e6 / args.m,
            "clocks_a_block": {k: buf[i] / blocks
                               for i, k in enumerate(STEPS)},
            "share": {k: buf[i] / total for i, k in enumerate(STEPS)}}),
            flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
