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


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, H, K) as float32 (B, H, S/chunk, chunk, K)."""
    bsz, s, h, k = t.shape
    return t.float().reshape(bsz, s // chunk, chunk, h, k).permute(
        0, 3, 1, 2, 4)


def _chunk_cum(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """cum of log max(a, 1e-37) inside each chunk: (B, H, S/chunk, chunk)."""
    bsz, s, h = a.shape
    loga = torch.log(torch.clamp_min(a.float(), 1e-37))
    return torch.cumsum(loga.reshape(bsz, s // chunk, chunk, h).permute(
        0, 3, 1, 2), dim=-1)


def chunk_states(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> torch.Tensor:
    """Every chunk's starting state (B, H, S/chunk, N, P) float32, as the
    forward kernel keeps them for the backward (the first is zero)."""
    xq, bq = _chunked(x, chunk), _chunked(b, chunk)
    cum = _chunk_cum(a, chunk)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum)
    upd = torch.einsum("bhqin,bhqip->bhqnp", bq * w[..., None], xq)
    hs = [torch.zeros_like(upd[:, :, 0])]
    for q in range(upd.shape[2] - 1):
        hs.append(torch.exp(total[:, :, q])[..., None, None] * hs[-1]
                  + upd[:, :, q])
    return torch.stack(hs, dim=2)


def _exact(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S/chunk, chunk, K) as (B, S, H, K)."""
    bsz, h, nq, q, k = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(bsz, nq * q, h, k)


def ssd_forward_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int, operand=_exact
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunk-parallel forward of ``ssd_chunked_ref``, in the order of
    the wgmma route of ``csrc/ssd.cu``, in float32: (y in x's dtype,
    h_last (B, H, N, P), every chunk's starting state (B, H, S/chunk, N,
    P)).  It is the oracle of that design (three passes), as
    ``ssd_backward_ref`` is of the backward's.

    A: per chunk q, S_q = (B o w)^T X with w = exp(total - cum).
    B: across chunks, H_start(0) = 0 and H_start(q+1) = exp(total_q)
       H_start(q) + S_q; h_last = H_start(last + 1).
    C: per chunk, from H_prev = H_start(q), with G = C B^T and
       L[i, j] = exp(cum_i - cum_j) (i >= j, masked before the exp):
         y = e o (C H_prev) + (G o L) X,  e = exp(cum).

    ``operand(name, t)`` gives the float32 operand ``t`` of a product as
    the tensor cores see it (``tools/ssd_rounding.py``); the names are
    "Bw" (B o w in S_q), "Hp" (H_prev in y) and "GL" (G o L in y).  The
    default keeps them exact."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nq = s // chunk
    xq, bq, cq = (_chunked(t, chunk) for t in (x, b, c))
    cum = _chunk_cum(a, chunk)                         # (B, H, nq, Q)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum)
    # A: S_q, chunk-parallel
    own = torch.einsum("bhqin,bhqip->bhqnp", operand("Bw", bq * w[..., None]),
                       xq)
    # B: the chunk-start states across chunks
    run = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    hs = []
    for q in range(nq):
        hs.append(run)
        run = torch.exp(total[:, :, q])[..., None, None] * run + own[:, :, q]
    states = torch.stack(hs, dim=2)                    # (B, H, nq, N, P)
    # C: the outputs, chunk-parallel
    idx = torch.arange(chunk, device=x.device)
    live = idx[:, None] >= idx[None, :]
    lmat = torch.exp(torch.where(live, cum[..., :, None] - cum[..., None, :],
                                 -torch.inf))
    g = cq @ bq.transpose(-1, -2)
    y = torch.exp(cum)[..., None] * (cq @ operand("Hp", states)) + \
        operand("GL", g * lmat) @ xq
    return _rows(y).to(x.dtype), run, states


def ssd_backward_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                     dh_last: Optional[torch.Tensor], chunk: int,
                     operand=_exact) -> Tuple[torch.Tensor, ...]:
    """The chunk-parallel backward of ``ssd_chunked_ref``, in the order of
    the wgmma route of ``csrc/ssd.cu``, in float32: (dx, da, db, dc), db
    and dc a head at a time.  It is the oracle of that design (three passes), not of
    the function, which is autograd of ``ssd_chunked_ref``.

    A: per chunk q, U_q = (C o e)^T dY with e = exp(cum).
    B: across chunks in reverse, dH_end(last) = dh_last (or 0) and
       dH_end(q) = exp(total_{q+1}) dH_end(q+1) + U_{q+1}: the gradient of
       chunk q's end state.
    C: per chunk, from H_prev = states[q] and dH = dH_end(q), with
       G = C B^T, dS = dY X^T, L[i, j] = exp(cum_i - cum_j) (i >= j, masked
       before the exp), M = dS o L, T = M o G, w = exp(total - cum):
         dx = w o (B dH) + (G o L)^T dY,
         dc = e o (dY H_prev^T) + M B,
         db = w o (X dH^T) + M^T C,
         dcum_i = sum_j T_ij - sum_j T_ji + e_i c_i . (dY H_prev^T)_i
                  - w_i dw_i + [i = Q-1] (sum_j w_j dw_j
                  + exp(total) <H_prev, dH>),  dw = rowsum(B o X dH^T),
         d log a = the reverse cumulative sum of dcum inside the chunk,
         da = d log a / a where a > 1e-37, else 0.

    ``operand(name, t)`` gives the float32 operand ``t`` of a product as
    the tensor cores see it (``tools/ssd_rounding.py``); the names are
    "Ce" (C o e in U), "GL" (G o L in dx), "M" (M in dc and db), "Hp"
    (H_prev in dc) and "dH" (dH in dx and db).  The default keeps them
    exact."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nq = s // chunk
    xq, bq, cq, dyq = (_chunked(t, chunk) for t in (x, b, c, dy))
    cum = _chunk_cum(a, chunk)                         # (B, H, nq, Q)
    total = cum[..., -1]
    e = torch.exp(cum)
    w = torch.exp(total[..., None] - cum)
    # A: U_q, chunk-parallel
    u = torch.einsum("bhqin,bhqip->bhqnp", operand("Ce", cq * e[..., None]),
                     dyq)
    # B: dH_end across chunks, in reverse
    run = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
           if dh_last is None else dh_last.float())
    dhs = [None] * nq
    for q in range(nq - 1, -1, -1):
        dhs[q] = run
        run = torch.exp(total[:, :, q])[..., None, None] * run + u[:, :, q]
    dh = torch.stack(dhs, dim=2)                       # (B, H, nq, N, P)
    hp = states.float()
    # C: the outputs, chunk-parallel
    idx = torch.arange(chunk, device=x.device)
    live = idx[:, None] >= idx[None, :]
    lmat = torch.exp(torch.where(live, cum[..., :, None] - cum[..., None, :],
                                 -torch.inf))
    g = cq @ bq.transpose(-1, -2)
    m = (dyq @ xq.transpose(-1, -2)) * lmat
    t = m * g
    dmat = dyq @ operand("Hp", hp).transpose(-1, -2)   # dY H_prev^T
    dc = e[..., None] * dmat + operand("M", m) @ bq
    xdh = xq @ operand("dH", dh).transpose(-1, -2)     # X dH^T
    dw = (bq * xdh).sum(-1)
    db = w[..., None] * xdh + operand("M", m).transpose(-1, -2) @ cq
    dx = w[..., None] * (bq @ operand("dH", dh)) + \
        operand("GL", g * lmat).transpose(-1, -2) @ dyq
    dcum = t.sum(-1) - t.sum(-2) + e * (cq * dmat).sum(-1) - w * dw
    dcum[..., -1] += (w * dw).sum(-1) + torch.exp(total) * (hp * dh).sum(
        (-1, -2))
    dloga = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    af = a.float()
    dloga = dloga.permute(0, 2, 3, 1).reshape(bsz, s, h)
    da = torch.where(af > 1e-37, dloga / af, torch.zeros_like(af))

    return _rows(dx), da, _rows(db), _rows(dc)


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
