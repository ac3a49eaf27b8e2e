"""Dispatchers for the per-block Gram kernels (port of
``repro/kernels/tree_sum/ops.py``): ``block_outer_sums`` (every leaf
block), ``gathered_block_grams`` (only the named blocks) and the batched
row update ``tree_update`` built on the latter.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/tree_sum.cu`` or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import block_outer_sums_ref, gathered_block_grams_ref


#: launches of the CUDA kernel by ``block_outer_sums`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0
#: the same count for ``gathered_block_grams``
gathered_launches = 0


def _lib():
    lib = _build.load("tree_sum")
    fn = lib.block_outer_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gathered_lib():
    lib = _build.load("tree_sum")
    fn = lib.gathered_block_grams_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_outer_sums(W: torch.Tensor, block: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W: (n*block, R) float32 -> (n, R, R) per-block Gram matrices,
    written into ``out`` when given (``construct_tree`` passes the leaf
    level of its node stack, so the leaf level is never copied)."""
    m, r = W.shape
    if block <= 0 or m % block:
        raise ValueError(f"row count {m} is not a multiple of block {block}")
    n = m // block
    if out is not None and (tuple(out.shape) != (n, r, r)
                            or out.dtype != torch.float32
                            or out.device != W.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({n}, {r}, {r}) "
                         f"tensor on {W.device}")
    if W.device.type == "cpu":
        res = block_outer_sums_ref(W, block)
        return res if out is None else out.copy_(res)
    if W.device.type != "cuda":
        raise ValueError(f"block_outer_sums runs on cpu or cuda, not "
                         f"{W.device}")
    if W.dtype != torch.float32 or not W.is_contiguous():
        raise ValueError("W must be a contiguous float32 tensor")
    if out is None:
        out = torch.empty((n, r, r), dtype=torch.float32, device=W.device)
    fn = _lib()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(W.data_ptr(), out.data_ptr(), n, block, r, stream),
                     "block_outer_sums")
    global launches
    launches += 1
    return out


def gathered_block_grams(W: torch.Tensor, blks: torch.Tensor,
                         block: int) -> torch.Tensor:
    """Grams of the leaf blocks named by ``blks`` only: W (n*block, R)
    float32, blks (nb,) integer block ids in [0, n) -> (nb, R, R).  On the
    card ``block_outer_sums``'s kernel runs on the named blocks, one CTA a
    block, so a recomputed block is bit-equal to the same block of a full
    build; repeated ids compute the same Gram again.  An id out of range
    yields a NaN Gram on the card (the kernel never reads outside W)."""
    m, r = W.shape
    if block <= 0 or m % block:
        raise ValueError(f"row count {m} is not a multiple of block {block}")
    if blks.dim() != 1 or blks.dtype.is_floating_point:
        raise ValueError("blks must be a 1-D integer tensor")
    if blks.device != W.device:
        raise ValueError(f"blks on {blks.device}, W on {W.device}")
    if W.device.type == "cpu":
        return gathered_block_grams_ref(W, blks, block)
    if W.device.type != "cuda":
        raise ValueError(f"gathered_block_grams runs on cpu or cuda, not "
                         f"{W.device}")
    if W.dtype != torch.float32 or not W.is_contiguous():
        raise ValueError("W must be a contiguous float32 tensor")
    ids = blks.to(torch.int64).contiguous()
    nb = ids.shape[0]
    out = torch.empty((nb, r, r), dtype=torch.float32, device=W.device)
    fn = _gathered_lib()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(W.data_ptr(), ids.data_ptr(), out.data_ptr(), nb,
                        m // block, block, r, stream), "gathered_block_grams")
    global gathered_launches
    gathered_launches += 1
    return out


def tree_update(nodes: torch.Tensor, W: torch.Tensor, idx: torch.Tensor,
                rows: torch.Tensor, block: int):
    """Batched row update of a flat sample tree: ``W[idx] <- rows`` (idx
    (B,) unique row indices, rows (B, R)), then the touched leaf blocks'
    Grams are recomputed by ``gathered_block_grams`` and the touched root
    paths resummed level by level with the same float32 ``left + right``
    as ``construct_tree`` — so the result is bit-equal to a rebuild on the
    updated rows, at O(B (block + log M) R^2) cost.

    Copy-on-write: ``nodes`` (the stacked levels, root first) and ``W`` are
    never written; the update lands in fresh copies, returned as
    ``(nodes, W)``.  A pinned snapshot holding the old tensors therefore
    never changes under an in-flight request.
    """
    n_blocks = W.shape[0] // block
    depth = n_blocks.bit_length() - 1
    idx = idx.to(device=W.device, dtype=torch.int64)
    w_new = W.clone()
    w_new[idx] = rows.to(W.dtype)
    blks = idx // block
    grams = gathered_block_grams(w_new, blks, block)
    new = nodes.clone()
    leaf0 = (1 << depth) - 1
    new[leaf0 + blks] = grams
    ids = blks
    for lvl in range(depth - 1, -1, -1):
        ids = ids // 2
        child = new[(1 << (lvl + 1)) - 1:(1 << (lvl + 2)) - 1]
        new[(1 << lvl) - 1 + ids] = child[2 * ids] + child[2 * ids + 1]
    return new, w_new
