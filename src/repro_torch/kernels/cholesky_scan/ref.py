"""Plain PyTorch versions of the Cholesky sampler's sequential scan
(Alg. 1).  ``cholesky_scan_ref`` is the reference's
``core/cholesky.py::sample_cholesky_inner`` step (:62-73), expression for
expression, batched over N draws as batched matrix-vector products on an
(N, R, R) state: the function the kernel is held to.
``cholesky_scan_blocked_ref`` is the same function computed as the
kernel's "blocked" route orders it, a block of b items at a time.  The
port's own kernel (``csrc/cholesky_scan.cu``) has no Pallas counterpart:
the reference runs this scan as a ``lax.scan``."""
from __future__ import annotations

import torch

#: the signed floor of the downdate's denominator (the reference's _EPS)
EPS = 1e-8


def cholesky_scan_ref(Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """Z (M, R) item rows, W (R, R) the inner matrix every draw starts from,
    u (N, M) uniforms.  Returns (take (N, M) bool, p (N, M) in the
    inputs' dtype): per draw n and item i in order, with Q_n = W at first,
    ``qz = Q z_i``, ``zq = z_i^T Q``, ``p = z_i . qz``, ``take = u < p``
    (strict: a zero-marginal item is never taken, at u = 0 included),
    ``denom = max(p, eps)`` if taken else ``min(p - 1, -eps)``, and
    ``Q -= qz zq^T / denom``."""
    m, r = Z.shape
    n = u.shape[0]
    q = W.expand(n, r, r).clone()
    take = torch.empty((n, m), dtype=torch.bool, device=Z.device)
    p_out = torch.empty((n, m), dtype=Z.dtype, device=Z.device)
    scan_rows_(q, Z, u, take, p_out)
    return take, p_out


def scan_rows_(q: torch.Tensor, Z: torch.Tensor, u: torch.Tensor,
               take: torch.Tensor, p_out: torch.Tensor) -> None:
    """``cholesky_scan_ref``'s steps over the rows of Z (M, R) from the
    states q (N, R, R), which it downdates in place, writing the decisions
    and marginals into take and p_out (N, M).  The step touches only
    tensors it is given, so a run of steps can be captured in a CUDA graph
    and replayed along a long scan (``chip_smoke.py``'s float64 scan)."""
    for i in range(Z.shape[0]):
        z = Z[i]
        qz = q @ z                                        # (N, R)
        zq = z @ q                                        # (N, R)
        p = qz @ z                                        # (N,)
        t = u[:, i] < p
        denom = torch.where(t, p.clamp_min(EPS), (p - 1.0).clamp_max(-EPS))
        q.sub_(qz[:, :, None] * zq[:, None, :] / denom[:, None, None])
        take[:, i] = t
        p_out[:, i] = p


def _decide(g: torch.Tensor, u: torch.Tensor, pivot_p: bool = False):
    """The block's b decisions and the inverse of its pivoted Gram, as the
    kernel's deciding warp computes them.  g: (N, b, b) with
    g[n, j, k] = z_j^T Q z_k; u: (N, b).  Gauss-Jordan in place without
    row exchange: at step j the eliminated diagonal is p_j, ``take = u_j <
    p_j``, and the pivot is the clamped denominator d_j (``max(p_j, eps)``
    if taken, else ``min(p_j - 1, -eps)``; ``pivot_p`` plants the fault
    ``min(p_j, -eps)``).  Eliminating with d_j carries each decision into
    the later items' p, so the p_j are the sequential scan's.  Returns
    (take (N, b), p (N, b), C (N, b, b)), C = (G + diag(d - p))^-1."""
    a = g.clone()
    n, b, _ = a.shape
    take = torch.empty((n, b), dtype=torch.bool, device=a.device)
    p_out = torch.empty((n, b), dtype=a.dtype, device=a.device)
    for j in range(b):
        p = a[:, j, j].clone()
        t = u[:, j] < p
        reject = (p if pivot_p else p - 1.0).clamp_max(-EPS)
        inv = 1.0 / torch.where(t, p.clamp_min(EPS), reject)
        f = a[:, :, j].clone()
        row = a[:, j, :].clone()
        row[:, j] = 1.0
        row = row * inv[:, None]
        a[:, :, j] = 0.0
        a = a - f[:, :, None] * row[:, None, :]
        a[:, j, :] = row
        take[:, j] = t
        p_out[:, j] = p
    return take, p_out, a


def _matmul(x: torch.Tensor, y: torch.Tensor, name: str) -> torch.Tensor:
    return x @ y


def cholesky_scan_blocked_ref(Z: torch.Tensor, W: torch.Tensor,
                              u: torch.Tensor, block: int, product=_matmul,
                              pivot_p: bool = False):
    """``cholesky_scan_ref``'s function computed a block of ``block`` items
    at a time, in the dtype of the inputs, as the kernel's "blocked" route
    orders it.  For a block Z_b (b x R, rows past M zero) and each draw's
    state Q: A = Q Z_b^T and B = Z_b Q (the kernel's tensor-core
    products), G = Z_b A (float32 FMA in the kernel), the b decisions and
    C = (G + diag(d - p))^-1 by ``_decide``, then the rank-b update
    Q -= (A C) B (two more tensor-core products).  ``product(x, y, name)``
    computes those four products, named "A", "B", "AC" and "update"
    (``tools/cholesky_rounding.py`` passes one that rounds the operands as
    the tensor cores see them); ``pivot_p`` plants ``_decide``'s fault.
    Returns (take (N, M) bool, p (N, M) in the inputs' dtype)."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    m, r = Z.shape
    n = u.shape[0]
    q = W.expand(n, r, r).clone()
    take = torch.empty((n, m), dtype=torch.bool, device=Z.device)
    p_out = torch.empty((n, m), dtype=Z.dtype, device=Z.device)
    for s in range(0, m, block):
        e = min(s + block, m)
        zb = Z.new_zeros((block, r))
        zb[: e - s] = Z[s:e]
        ub = u.new_ones((n, block))
        ub[:, : e - s] = u[:, s:e]
        a = product(q, zb.T, "A")                        # (N, R, b)
        bm = product(zb, q, "B")                         # (N, b, R)
        g = zb @ a                                       # (N, b, b)
        t, p, c = _decide(g, ub.to(g.dtype), pivot_p)
        q = q - product(product(a, c, "AC"), bm, "update")
        take[:, s:e] = t[:, : e - s]
        p_out[:, s:e] = p[:, : e - s]
    return take, p_out


def random_inputs(m: int, r: int, n: int, seed: int, device,
                  zero_rows=(), scale: float | None = None):
    """Seeded inputs for holding a scan to this one: rows Z (m, r) of a
    random NDPP (L = Z X Z^T, X = I + S with S skew), normal draws times
    ``scale`` (1 / sqrt(m) by default, which gives marginals of O(0.1)),
    the rows in ``zero_rows`` zero; W = X (I + Z^T Z X)^-1 from float64;
    uniforms u (n, m).  All float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((m, r), generator=gen, device=device, dtype=torch.float64)
    z = z / max(m, 1) ** 0.5 if scale is None else z * scale
    z[list(zero_rows)] = 0.0
    a = torch.randn((r, r), generator=gen, device=device, dtype=torch.float64)
    eye = torch.eye(r, device=device, dtype=torch.float64)
    x = eye + 0.5 * (a - a.T)
    w = x @ torch.linalg.inv(eye + z.T @ z @ x)
    u = torch.rand((n, m), generator=gen, device=device)
    return z.float().contiguous(), w.float().contiguous(), u


#: the faults ``planted_scan`` plants: p and take all zero; no downdate (each
#: item an independent Bernoulli(K_ii), which keeps E|Y| = tr(K)); the
#: denominator's sign flipped; the blocked form with a rejected item's
#: pivot left at p instead of p - 1
FAULTS = ("zeros", "skip_downdate", "flip_sign", "pivot_p")

#: the block of the "pivot_p" fault: the kernel's blocked route's
FAULT_BLOCK = 32


def planted_scan(Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor,
                 fault: str):
    """``cholesky_scan_ref`` with one fault of ``FAULTS`` planted: the
    controls a check by ``flip_gaps`` must refuse."""
    n, m = u.shape
    if fault == "zeros":
        return (torch.zeros((n, m), dtype=torch.bool, device=u.device),
                torch.zeros((n, m), dtype=torch.float32, device=u.device))
    if fault == "skip_downdate":
        p = ((Z @ W) * Z).sum(-1).expand(n, m).to(torch.float32)
        return u < p, p.contiguous()
    if fault == "pivot_p":
        return cholesky_scan_blocked_ref(Z, W, u, FAULT_BLOCK, pivot_p=True)
    if fault != "flip_sign":
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    q = W.expand(n, *W.shape).clone()
    take = torch.empty((n, m), dtype=torch.bool, device=Z.device)
    p_out = torch.empty((n, m), dtype=torch.float32, device=Z.device)
    for i in range(m):
        z = Z[i]
        qz, zq = q @ z, z @ q
        p = qz @ z
        t = u[:, i] < p
        denom = torch.where(t, p.clamp_min(EPS), (p - 1.0).clamp_max(-EPS))
        q = q + qz[:, :, None] * zq[:, None, :] / denom[:, None, None]
        take[:, i] = t
        p_out[:, i] = p
    return take, p_out


#: the flip rule's limit on |p - p_ref| is RTOL |p_ref| + ATOL_FRAC max|p_ref|:
#: float32 rounding, relative to each marginal, plus a floor for marginals
#: that cancel to near zero, relative to the largest of the call
RTOL = 1e-4
ATOL_FRAC = 1e-6


def flip_gaps(take: torch.Tensor, p: torch.Tensor, take_ref: torch.Tensor,
              p_ref: torch.Tensor, u: torch.Tensor, rtol: float = RTOL,
              atol_frac: float = ATOL_FRAC) -> dict:
    """How a scan's (take, p) stand against the plain version's on the same
    uniforms u, all (N, M), by the flip rule.  Once two scans decide an
    item differently their states part and nothing later is comparable, so
    per draw only the items up to the first flip count.  The limit of an
    item is ``rtol |p_ref| + atol`` with ``atol = atol_frac max|p_ref|``;
    ``p_excess`` is the largest |p - p_ref| over its limit before the first
    flip, ``flip_excess`` the largest |u - p_ref| over its limit at it (a
    flip is fair only where the plain p lies that close to u); ``within``
    is both at most 1 (a non-finite p is not).  Also ``max_p_gap`` (the
    largest |p - p_ref| compared), ``flipped_draws`` and ``compared_takes``
    (the plain version's takes before the first flips: the decisions the
    rule held)."""
    n, m = take.shape
    diff = take != take_ref
    flipped = diff.any(dim=1)
    first = torch.where(flipped, diff.to(torch.int8).argmax(dim=1),
                        torch.full((n,), m, dtype=torch.int64,
                                   device=take.device))
    before = torch.arange(m, device=take.device)[None, :] < first[:, None]
    scale = float(p_ref.abs().max()) if p_ref.numel() else 0.0
    atol = atol_frac * scale
    limit = rtol * p_ref.abs() + atol
    gap = (p - p_ref).abs().nan_to_num(nan=float("inf"))
    zero = torch.zeros_like(gap)
    excess = torch.where(before, gap / limit, zero).nan_to_num(nan=0.0)
    rows = torch.nonzero(flipped).flatten()
    margin = (u - p_ref)[rows, first[rows]].abs() / limit[rows, first[rows]]
    out = {"max_p_gap": float(torch.where(before, gap, zero).max())
                        if gap.numel() else 0.0,
           "p_excess": float(excess.max()) if gap.numel() else 0.0,
           "flip_excess": float(margin.max()) if rows.numel() else 0.0,
           "flipped_draws": int(rows.numel()),
           "compared_takes": int((take_ref & before).sum()),
           "rtol": rtol, "atol": atol}
    out["within"] = out["p_excess"] <= 1.0 and out["flip_excess"] <= 1.0
    return out
