"""Dispatcher for the per-block Gram kernel (port of
``repro/kernels/tree_sum/ops.py::block_outer_sums``).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/tree_sum.cu`` or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .ref import block_outer_sums_ref


#: launches of the CUDA kernel by ``block_outer_sums`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0

def _lib():
    lib = _build.load("tree_sum")
    fn = lib.block_outer_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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

