"""Plain PyTorch version of causal GQA attention (port of
``repro/kernels/attention/ref.py``): the oracle of the flash kernels'
forward (``csrc/flash_attn_sm90.cu`` and ``csrc/flash_attn.cu``), and,
through autograd, of their backward."""
from __future__ import annotations

from typing import Optional

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None,
            kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, KVH, Sk, D), H a multiple of KVH (head h
    reads kv head h // (H / KVH)); float32 math, output in q's dtype.
    Queries are the *last* Sq positions of the Sk keys; with ``kv_len``
    (B,) they are the last Sq of each sequence's valid prefix.  Masked
    scores are -1e30, as the reference's."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    assert h % kvh == 0
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    sk = k.shape[2]
    kpos = torch.arange(sk, dtype=torch.int64, device=q.device)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int64)
        qpos = kv_len[:, None] - sq + torch.arange(
            sq, dtype=torch.int64, device=q.device)[None, :]        # (B, sq)
        mask = qpos[:, :, None] >= kpos[None, None, :]
        if not causal:  # still mask padding beyond kv_len
            mask = kpos[None, None, :] < kv_len[:, None, None]
        s = torch.where(mask[:, None], s, -1e30)
    elif causal:
        qpos = torch.arange(sq, dtype=torch.int64, device=q.device) + (sk - sq)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def bf16_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far a bfloat16 kernel output lies from its float32 oracle, in
    units of the tolerance: the largest |got - want| / (2^-8 |want| +
    2^-8 max|row of want| + 2^-16 max|want|); at most 1 passes.

    A row is the last axis: a (b, h, query) row of O or dq, a (b, kv head,
    key) row of dk or dv.  2^-8 |want| is one bfloat16 rounding of the
    output; the row term takes the float32 sums and, in the backward, the
    delta computed from the bf16-rounded O; the global floor takes rows
    whose exact value is 0 (query 0's dq).  Values shrink along the
    sequence (a late query averages many keys, a late key is seen by few
    queries), so a tolerance scaled by the global max would pass a late
    row that is zero or read the wrong head."""
    g, w = got.float(), want.float()
    aw = w.abs()
    allowed = (2.0 ** -8 * aw + 2.0 ** -8 * aw.amax(-1, keepdim=True)
               + 2.0 ** -16 * aw.max())
    return float(((g - w).abs() / allowed).max())


def mha_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True,
                scale: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp (B, H, Sq) float32 of the scaled, masked scores
    that ``mha_ref`` softmaxes: what the kernel's forward keeps for its
    backward."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    kf = k.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    if causal:
        sk = k.shape[2]
        kpos = torch.arange(sk, device=q.device)
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s, -1e30)
    return torch.logsumexp(s, dim=-1)
