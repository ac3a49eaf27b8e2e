#!/usr/bin/env python3
"""CPU emulation of where the Cholesky scan's "blocked" route
(``csrc/cholesky_scan.cu``) rounds, held against the plain scan in float64
by the flip rule (``ref.flip_gaps``: an excess of at most 1 passes).

    PYTHONPATH=src python tools/cholesky_rounding.py [--split tf32x3 ...]
        [--draws 16] [--main-rows 16384] [--seed 1]

The blocked plain version (``ref.cholesky_scan_blocked_ref``, b = 32) runs
in float32 with its four tensor-core products (A = Q Z_b^T, B = Z_b Q,
A C and the update (A C) B) computed from operands rounded as the tensor
cores would see them under each split, summed in float64 and rounded to
float32 (so not in the card's order):

- ``float32``: the operands as they are;
- ``tf32x3``: the kernel's: each operand a TF32 pair, the product hi.hi +
  hi.lo + lo.hi; hi is the value rounded to TF32 and lo what that lost,
  rounded again, but for Z_b, whose hi is Z_b truncated (the kernel keeps
  Z_b's float32 bits in shared memory and the tensor cores ignore their
  low 13 bits);
- ``bf16x2``: bf16 pairs, the same three terms;
- ``tf32``: one TF32 rounding of each operand.

Cases: the card tests' scan cases (``tests/test_torch_gpu.py``
``_SCAN_CASES`` at R <= 208, the blocked route's), 1,024 rows of
marginals O(0.1) at R = 200, and ``--main-rows`` rows at R = 200 scaled
to the main path's marginals (~7.6e-6, E|Y| ~ 10 at M = 2^20).  Inputs
are ``ref.random_inputs``.  Prints one JSON line a case and split (its
excess, flips and the takes the rule held), then each split's largest
excess.  Seconds to minutes on the CPU; imports no JAX.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels.cholesky_scan.ref import (  # noqa: E402
    cholesky_scan_blocked_ref, cholesky_scan_ref, flip_gaps, random_inputs)

SPLITS = ("float32", "tf32x3", "bf16x2", "tf32")
BLOCK = 32
#: the main path's marginals: E|Y| ~ 10 over M = 2^20 rows is ~9.5e-6 an
#: item; its state gives ~7.6e-6 (PERF.md, the cholesky cell)
MAIN_P = 7.6e-6


def _tf32(x: torch.Tensor, trunc: bool = False) -> torch.Tensor:
    """x (float32) rounded to TF32: to nearest, ties away from zero (as
    ``cvt.rna.tf32.f32``), or truncated."""
    bits = x.contiguous().view(torch.int32)
    if not trunc:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _pair(x: torch.Tensor, split: str, z_side: bool):
    """x's (hi, lo) as the tensor cores see them under ``split`` (lo None
    where x enters once)."""
    if split == "float32":
        return x, None
    if split == "tf32":
        return _tf32(x), None
    if split == "bf16x2":
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()
    hi = _tf32(x, trunc=z_side)
    return hi, _tf32(x - hi)


def emulated(split: str):
    """The ``product`` hook of ``cholesky_scan_blocked_ref`` under
    ``split``: Z_b is the right operand of "A" and the left of "B"."""

    def product(x, y, name):
        xh, xl = _pair(x, split, z_side=name == "B")
        yh, yl = _pair(y, split, z_side=name == "A")
        out = xh.double() @ yh.double()
        if xl is not None:
            out = out + xh.double() @ yl.double() + xl.double() @ yh.double()
        return out.float()

    return product


def cases(draws: int, main_rows: int, seed: int):
    """(name, Z, W, u): the card tests' cases at R <= 208, 1,024 rows of
    O(0.1) marginals, the main path's marginals."""
    grid = ([(257, r, 3) for r in (1, 8, 33, 200)]
            + [(m, 200, 5) for m in (1, 63, 64, 65, 4097)]
            + [(300, 64, n) for n in (1, 131, 132, 133, 300)])
    for m, r, n in grid:
        yield (f"M {m}, R {r}, N {n}",
               *random_inputs(m, r, n, m * 1000 + r + n, "cpu"))
    yield ("zero rows, M 1024, R 200, N 133", *random_inputs(
        1024, 200, 133, 7, "cpu", zero_rows=(0, 5, 6, 100, 1023)))
    yield (f"O(0.1) marginals, M 1024, R 200, N {draws}",
           *random_inputs(1024, 200, draws, seed, "cpu"))
    yield (f"main-path marginals, M {main_rows}, R 200, N {draws}",
           *random_inputs(main_rows, 200, draws, seed + 1, "cpu",
                          scale=(MAIN_P / 200) ** 0.5))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", nargs="+", default=list(SPLITS),
                    choices=SPLITS)
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--main-rows", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    worst = {s: 0.0 for s in args.split}
    for name, z, w, u in cases(args.draws, args.main_rows, args.seed):
        take64, p64 = cholesky_scan_ref(z.double(), w.double(), u.double())
        for split in args.split:
            take, p = cholesky_scan_blocked_ref(z, w, u, BLOCK,
                                                product=emulated(split))
            g = flip_gaps(take, p, take64, p64.float(), u)
            excess = max(g["p_excess"], g["flip_excess"])
            worst[split] = max(worst[split], excess)
            print(json.dumps({"case": name, "split": split,
                              "excess": excess, "p_excess": g["p_excess"],
                              "flip_excess": g["flip_excess"],
                              "flipped_draws": g["flipped_draws"],
                              "compared_takes": g["compared_takes"],
                              "mean_p": float(p64.mean())}), flush=True)
    print(json.dumps({"largest_excess": worst, "block": BLOCK}))


if __name__ == "__main__":
    main()
