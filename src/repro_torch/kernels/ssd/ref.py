"""Plain PyTorch versions of the Mamba2 SSD scan (port of
``repro/kernels/ssd/ref.py`` and of ``ssd_chunked_ref`` in
``repro/kernels/ssd/ops.py``): the oracles of ``csrc/ssd.cu``'s forward and,
through autograd, of its backward.

Per head: state h in R^{N x P}; per step a scalar decay a_t in (0, 1]:

    h_t = a_t h_{t-1} + b_t x_t^T        (b_t in R^N, x_t in R^P)
    y_t = c_t^T h_t                      (c_t in R^N)

Layouts are the reference's: x (B, S, H, P), a (B, S, H), b and c
(B, S, H, N), a state (B, H, N, P); float32 arithmetic, y in x's dtype and
the last state in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence as a plain loop over time (O(S N P) a head)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    hs = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    ys = []
    for t in range(s):
        hs = hs * af[:, t, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", bf[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], hs))
    return torch.stack(ys, dim=1).to(x.dtype), hs


def ssd_chunked_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, h0: Optional[torch.Tensor] = None,
                    chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked algorithm (the same math as the kernel), differentiable
    by autograd: per chunk of Q steps, with cum the cumulative sum of
    log max(a, 1e-37) inside the chunk,

        y = (C B^T o L) X + (C o exp(cum)) H_prev,
            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0,
        H = exp(cum_last) H_prev + (B o exp(cum_last - cum))^T X.

    L is masked *before* the exp, as the reference's: for i < j the
    exponent is positive and may overflow, and exp-then-mask would make
    the gradient inf * 0 = NaN."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    nq = s // chunk
    xf = x.float().reshape(bsz, nq, chunk, h, p)
    af = a.float().reshape(bsz, nq, chunk, h)
    bf = b.float().reshape(bsz, nq, chunk, h, n)
    cf = c.float().reshape(bsz, nq, chunk, h, n)
    hprev = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float())

    loga = torch.log(torch.clamp_min(af, 1e-37))
    cum = torch.cumsum(loga, dim=2)                    # (B, nq, Q, H)
    total = cum[:, :, -1]                              # (B, nq, H)
    idx = torch.arange(chunk, device=x.device)
    lmask = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for t in range(nq):
        xq, bq, cq = xf[:, t], bf[:, t], cf[:, t]
        cumq, totq = cum[:, t], total[:, t]
        lexp = torch.where(lmask, cumq[:, :, None] - cumq[:, None, :],
                           -torch.inf)
        lmat = torch.exp(lexp)                         # (B, Q, Q, H)
        y_inter = torch.einsum("bqhn,bhnp->bqhp",
                               cq * torch.exp(cumq)[..., None], hprev)
        s_mat = torch.einsum("bqhn,bkhn->bqkh", cq, bq) * lmat
        y_intra = torch.einsum("bqkh,bkhp->bqhp", s_mat, xq)
        w = torch.exp(totq[:, None] - cumq)            # (B, Q, H)
        hprev = torch.exp(totq)[:, :, None, None] * hprev + torch.einsum(
            "bqhn,bqhp->bhnp", bq * w[..., None], xq)
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y.to(x.dtype), hprev


def row_excess(got: torch.Tensor, want: torch.Tensor, row_dims: int = 1,
               rel: float = 2.0 ** -8) -> float:
    """How far ``got`` lies from its oracle ``want``, in units of a
    tolerance scaled row by row: the largest |got - want| / (rel |want| +
    rel max|row of want| + rel 2^-8 max|want|); at most 1 passes.

    A row is the last ``row_dims`` axes: a (batch, step, head) row of y,
    dx, db or dc (``row_dims=1``), a (batch, head) state of h_last
    (``row_dims=2``).  ``rel = 2^-8`` is one bfloat16 rounding; the row
    term takes float32 sums in another order and the roundings of values
    near a row's largest; the global floor takes rows whose exact value
    is 0.  y decays along a chunk and across heads, so a tolerance scaled
    by the global max would pass a late or strongly decayed row that is
    zero or read the wrong head's decays."""
    g, w = got.detach().float(), want.detach().float()
    aw = w.abs()
    rmax = aw.flatten(-row_dims).amax(-1)
    rmax = rmax.reshape(rmax.shape + (1,) * row_dims)
    allowed = rel * aw + rel * rmax + rel * 2.0 ** -8 * aw.max()
    return float(((g - w).abs() / allowed).max())


def da_rows(da: torch.Tensor, chunk: int) -> torch.Tensor:
    """da (B, S, H) as rows of one chunk of one head, (B, H, S/chunk,
    chunk): da's reverse cumulative sum runs inside a chunk, so a chunk is
    its natural row for ``row_excess``."""
    bsz, s, h = da.shape
    return da.permute(0, 2, 1).reshape(bsz, h, s // chunk, chunk)
