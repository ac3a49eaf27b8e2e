#!/usr/bin/env python3
"""CPU emulation of where a bf16 tensor-core flash attention rounds, held
against the float32 oracle with ``ref.bf16_excess`` (the tolerance the
kernels are gated by).

    PYTHONPATH=src python tools/flash_rounding.py [--seq 2048] [--g 8]
        [--split fwd,dq,dk,dv] [--seed 1]

On normal bf16 inputs (B = 1, one kv head, g query heads, D = 128) it
computes O the way ``csrc/flash_attn_sm90.cu`` does, tile by tile with
an online softmax in which P meets V as bf16, and the backward with P
and dS as bf16 operands, delta taken from the float32 O so made.  Each
product named in ``--split`` takes its bf16 operand as a pair hi + lo
(hi the value rounded, lo what that lost, rounded again) instead of
rounding it once.  Prints the excess of O, dq, dk and dv; <= 1 passes.
Needs a few GB of memory at S = 2048, g = 8.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels.attention.ref import bf16_excess, mha_ref  # noqa: E402


def rounded(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x as the tensor cores see it: bf16 once, or as bf16 hi + lo."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def run(seq: int, g: int, split: set, seed: int, d: int = 128,
        tile: int = 128) -> dict:
    gen = torch.Generator().manual_seed(seed)
    mk = lambda h: torch.randn(1, h, seq, d, generator=gen).bfloat16()
    q, k, v, dout = mk(g), mk(1), mk(1), mk(g)
    scale = d ** -0.5
    qf, kf, vf, df = q.float(), k.float().expand(-1, g, -1, -1), \
        v.float().expand(-1, g, -1, -1), dout.float()
    live = torch.ones(seq, seq, dtype=torch.bool).tril()
    s = torch.where(live, qf @ kf.transpose(-1, -2) * scale, -1e30)
    m = torch.full((1, g, seq, 1), -1e30)
    l, o = torch.zeros(1, g, seq, 1), torch.zeros(1, g, seq, d)
    for k0 in range(0, seq, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + rounded(p, "fwd" in split) @ vf[:, :, k0:k0 + tile]
        m = m_new
    o = o / l
    lse = m + torch.log(l)
    p = torch.exp(s - lse)
    ds = p * (df @ vf.transpose(-1, -2) - (df * o).sum(-1, keepdim=True))
    dv = (rounded(p, "dv" in split).transpose(-1, -2) @ df).sum(1, True)
    dk = (rounded(ds, "dk" in split).transpose(-1, -2) @ qf * scale).sum(
        1, True)
    dq = rounded(ds, "dq" in split) @ kf * scale
    qg, kg, vg = (t.float().requires_grad_(True) for t in (q, k, v))
    want = mha_ref(qg, kg, vg)
    wq, wk, wv = torch.autograd.grad(want, (qg, kg, vg), df)
    return {"O": bf16_excess(o.bfloat16(), want.detach()),
            "dq": bf16_excess(dq.bfloat16(), wq),
            "dk": bf16_excess(dk.bfloat16(), wk),
            "dv": bf16_excess(dv.bfloat16(), wv)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--g", type=int, default=8)
    ap.add_argument("--split", default="",
                    help="comma-separated products from fwd, dq, dk, dv")
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    split = {x for x in a.split.split(",") if x}
    print(run(a.seq, a.g, split, a.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
