#!/usr/bin/env python3
"""CPU emulation of where the SSD scan's bf16 tensor-core routes
(``csrc/ssd.cu``) round, held against the plain scan in float32 with
``ssd/ref.py::row_excess`` under the tolerances ``chip_smoke.py`` gates on
(2^-8 for the bf16 outputs y, dx, db, dc; 2^-12 for the float32 ones
h_last, the chunk-start states and d log a).

    PYTHONPATH=src python tools/ssd_rounding.py [--direction bwd|fwd]
        [--heads 4] [--seq 1024] [--split Ce,GL,M,Hp,dH] [--decays mixer|LO]
        [--seed 1]

Inputs are bf16 at P = 64, N = 128, chunk 128 (batch 1), B and C one row
over all heads, dy normal.  ``--decays mixer`` makes a and x as the
Mamba2 mixer does (a = exp(-A_h dt), A_h = 1..16 over the heads,
dt = softplus(z), x scaled by dt); a number LO draws log a uniform in
[log LO, 0] with normal x, as ``tests/test_torch_gpu.py``.  The backward
(``--direction bwd``, against autograd of ``ssd_chunked_ref``) runs as
``ssd_backward_ref`` orders it, from float32 chunk-start states; the
forward (``--direction fwd``, against ``ssd_chunked_ref`` and
``chunk_states``) as ``ssd_forward_ref`` orders it.  Products of two bf16
inputs are exact, the float32 operands named in ``--split`` enter as a
bf16 pair hi + lo (hi the value rounded, lo what that lost, rounded
again), the others rounded once to bf16, and the bf16 outputs are rounded
as the kernels write them.  Prints the excess of each output; <= 1
passes.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels.ssd.ref import (  # noqa: E402
    chunk_states, da_rows, row_excess, ssd_backward_ref, ssd_chunked_ref,
    ssd_forward_ref)

#: the float32 operands of each route's products (``ssd_backward_ref``'s
#: and ``ssd_forward_ref``'s names)
OPERANDS = {"bwd": ("Ce", "GL", "M", "Hp", "dH"), "fwd": ("Bw", "Hp", "GL")}
REL, REL32 = 2.0 ** -8, 2.0 ** -12


def rounded(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x as the tensor cores see it: bf16 once, or as bf16 hi + lo."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def inputs(heads: int, seq: int, decays: str, seed: int, p: int = 64,
           n: int = 128):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen)
    if decays == "mixer":
        dt = torch.nn.functional.softplus(mk(1, seq, heads))
        a = torch.exp(-torch.linspace(1.0, 16.0, heads) * dt)
        x = (mk(1, seq, heads, p) * dt[..., None]).bfloat16()
    else:
        lo = float(decays)
        u = torch.rand(1, seq, heads, generator=gen)
        a = torch.exp(u * torch.log(torch.tensor(lo)))
        x = mk(1, seq, heads, p).bfloat16()
    b = mk(1, seq, 1, n).bfloat16().expand(1, seq, heads, n)
    c = mk(1, seq, 1, n).bfloat16().expand(1, seq, heads, n)
    return x, a, b, c, mk(1, seq, heads, p).bfloat16()


def run(heads: int, seq: int, split: set, decays: str, seed: int,
        chunk: int = 128) -> dict:
    x, a, b, c, dy = inputs(heads, seq, decays, seed)
    leaves = [t.float().contiguous().requires_grad_(True) for t in (x, a, b, c)]
    want = torch.autograd.grad(ssd_chunked_ref(*leaves, chunk=chunk)[0],
                               leaves, dy.float())
    states = chunk_states(x, a, b, c, chunk)
    dx, da, db, dc = ssd_backward_ref(
        x, a, b, c, states, dy, None, chunk,
        operand=lambda name, t: rounded(t, name in split))
    return {"dx": row_excess(dx.bfloat16(), want[0], 1, REL),
            "dloga": row_excess(da_rows(da * a, chunk),
                                da_rows(want[1] * a, chunk), 1, REL32),
            "db": row_excess(db.bfloat16(), want[2], 1, REL),
            "dc": row_excess(dc.bfloat16(), want[3], 1, REL)}


def run_fwd(heads: int, seq: int, split: set, decays: str, seed: int,
            chunk: int = 128) -> dict:
    x, a, b, c, _ = inputs(heads, seq, decays, seed)
    want_y, want_h = ssd_chunked_ref(x.float(), a, b.float(), c.float(),
                                     chunk=chunk)
    want_st = chunk_states(x, a, b, c, chunk)
    y, h_last, states = ssd_forward_ref(
        x, a, b, c, chunk, operand=lambda name, t: rounded(t, name in split))
    return {"y": row_excess(y, want_y, 1, REL),
            "h_last": row_excess(h_last, want_h, 2, REL32),
            "states": row_excess(states, want_st, 2, REL32)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction", choices=sorted(OPERANDS), default="bwd")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--split", default="",
                    help="comma-separated operands: backward " + ", ".join(
                        OPERANDS["bwd"]) + "; forward " + ", ".join(
                        OPERANDS["fwd"]))
    ap.add_argument("--decays", default="mixer")
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    split = {x for x in a.split.split(",") if x}
    if split - set(OPERANDS[a.direction]):
        ap.error(f"unknown operands {sorted(split - set(OPERANDS[a.direction]))}")
    fn = run if a.direction == "bwd" else run_fwd
    print({"direction": a.direction, "split": sorted(split),
           "decays": a.decays, "seed": a.seed,
           **fn(a.heads, a.seq, split, a.decays, a.seed)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
