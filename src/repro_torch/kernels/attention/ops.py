"""Public attention op (port of ``repro/kernels/attention/ops.py``):
``mha``, causal GQA attention, with a hand-written backward.

A tensor on the CPU goes to the plain version in ``ref.py`` (``mha_ref``),
differentiated by autograd.  A CUDA tensor launches a flash kernel through
``FlashAttention`` (the forward kernel, and its backward kernel in
autograd's backward pass) or raises — there is no shape gate that quietly
runs the plain version.  ``_route`` picks the kernel from the dtype and
the head dim alone: bfloat16 with D a multiple of 16 up to 128 goes to the
tensor-core kernels of ``csrc/flash_attn_sm90.cu`` ("wgmma"); float32, and
bfloat16 at the other head dims (D = 8 mod 16, or above 128), to the SIMT
kernels of ``csrc/flash_attn.cu`` ("simt").
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import mha_ref

#: the widest head dim a kernel takes (the SIMT kernels' D_PAD = 256 tiles)
MAX_D = 256

#: launches of the forward kernel since the count was last set to 0
#: (a checkpointed layer's forward runs again in the backward and counts
#: again); plain-version calls on CPU tensors do not count
launches = 0
#: calls of the backward kernel (its delta, dK/dV and dQ launches count as
#: one) since the count was last set to 0
bwd_launches = 0
#: the same two counts by route (``_route``): each launch adds one to its
#: route's count and to the total above
wgmma_launches = 0
simt_launches = 0
wgmma_bwd_launches = 0
simt_bwd_launches = 0

_F = ctypes.c_void_p
_I = ctypes.c_int


def _route(dtype: torch.dtype, d: int) -> Optional[str]:
    """The kernels that take (dtype, head dim d): "wgmma" (bfloat16, d a
    multiple of 16 up to 128: the tensor-core kernels), "simt" (float32,
    or bfloat16 at the other multiples of 8 up to 256: the float32-FMA
    kernels), or None where none does."""
    if dtype not in (torch.float32, torch.bfloat16) or d <= 0 or d % 8:
        return None
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 128:
        return "wgmma"
    return "simt" if d <= MAX_D else None


def _fwd_lib(route: str):
    if route == "wgmma":
        fn = _build.load("flash_attn_sm90").flash_attn_sm90_fwd_launch
        fn.argtypes = [_F] * 6 + [_I] * 6 + [ctypes.c_float, _I, _F]
    else:
        fn = _build.load("flash_attn").flash_attn_fwd_launch
        fn.argtypes = [_F] * 6 + [_I] * 6 + [ctypes.c_float, _I, _I, _F]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib(route: str):
    if route == "wgmma":
        fn = _build.load("flash_attn_sm90").flash_attn_sm90_bwd_launch
        fn.argtypes = [_F] * 11 + [_I] * 6 + [ctypes.c_float, _I, _F]
    else:
        fn = _build.load("flash_attn").flash_attn_bwd_launch
        fn.argtypes = [_F] * 10 + [_I] * 6 + [ctypes.c_float, _I, _I, _F]
    fn.restype = ctypes.c_int
    return fn


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, D), k = v (B, KVH, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim, or H is not a multiple of "
                         f"KVH")
    if not 0 < sq <= k.shape[2]:
        raise ValueError(f"the kernel takes 0 < Sq <= Sk; got Sq = {sq}, "
                         f"Sk = {k.shape[2]}")
    if d % 8 or d > MAX_D:
        raise ValueError(f"the kernel takes a head dim that is a multiple "
                         f"of 8 up to {MAX_D}; got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, not "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA q, k, v: (O like q, the row log-sum-exp
    (B, H, Sq) float32, O in float32 before its rounding to q's dtype, the
    same tensor as O for float32 inputs).  The backward takes the last."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    route = _route(q.dtype, d)
    q, k, v = _dense(q), _dense(k), _dense(v)
    o = torch.empty_like(q)
    o32 = o if q.dtype == torch.float32 else torch.empty_like(
        q, dtype=torch.float32)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _fwd_lib(route)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if o32 is o else o32.data_ptr(), lse.data_ptr(), b, h, kvh,
            sq, sk, d, float(scale), int(causal)]
    if route == "simt":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(*args, stream), f"flash_attn forward ({route})")
    global launches, wgmma_launches, simt_launches
    launches += 1
    if route == "wgmma":
        wgmma_launches += 1
    else:
        simt_launches += 1
    return o, lse, o32


def flash_backward(q, k, v, o32, lse, dout, causal: bool, scale: float):
    """The backward kernel: (dq, dk, dv) in q's, k's and v's dtypes from the
    forward's inputs, its float32 O (``flash_forward``'s third output) and
    log-sum-exp, and dO.  delta = rowsum(dO o O) is taken from the float32
    O: from O rounded to bfloat16 it would swamp dq of a row whose
    attention sits on one key."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if dout.shape != o32.shape or o32.shape != q.shape:
        raise ValueError(f"dO {tuple(dout.shape)} and O {tuple(o32.shape)} "
                         f"must be shaped like q {tuple(q.shape)}")
    if o32.dtype != torch.float32:
        raise ValueError(f"the backward takes O in float32, the forward's "
                         f"third output, not {o32.dtype}")
    route = _route(q.dtype, d)
    q, k, v, o32 = _dense(q), _dense(k), _dense(v), _dense(o32)
    dout = _dense(dout.to(q.dtype))
    lse = _dense(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if route == "wgmma":
        # scratch for delta and for lse scaled by log2 e, in rows padded
        # to whole dQ tiles
        rows = _build.load("flash_attn_sm90").flash_attn_sm90_scratch_rows
        rows.argtypes, rows.restype = [_I], _I
        sq_pad = rows(sq)
        delta = torch.empty((b, h, sq_pad), dtype=torch.float32,
                            device=q.device)
        lse2 = torch.empty_like(delta)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                lse2.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, kvh, sq, sk, d, float(scale),
                int(causal)]
    else:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq,
                sk, d, float(scale), int(causal),
                int(q.dtype == torch.bfloat16)]
    fn = _bwd_lib(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(*args, stream), f"flash_attn backward ({route})")
    global bwd_launches, wgmma_bwd_launches, simt_bwd_launches
    bwd_launches += 1
    if route == "wgmma":
        wgmma_bwd_launches += 1
    else:
        simt_bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``mha`` on the card: the forward kernel, saving q, k, v, O in
    float32 and the log-sum-exp; the backward kernel for the gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse, o32 = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o32, lse, dout, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention.  q: (B, H, Sq, D), k/v: (B, KVH, Sk, D) ->
    (B, H, Sq, D) in q's dtype; the queries are the last Sq key positions.

    CPU tensors: ``mha_ref`` (with ``kv_len``, the ragged-cache masking).
    CUDA tensors: the flash kernel, differentiable; ``kv_len`` belongs to
    the KV-cache path of the LM serving slice, not ported yet (ROADMAP.md,
    Queue 1), and raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, not {q.device}")
    if kv_len is not None:
        raise NotImplementedError(
            "mha with kv_len (a ragged KV cache) on the card comes with the "
            "LM serving slice; see ROADMAP.md, Queue 1")
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))
