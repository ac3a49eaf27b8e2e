"""Dispatcher for the fused round descent + leaf scoring kernel (port of
``repro/kernels/spec_round/ops.py::descend_score``).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/spec_round.cu`` or raises — there is no fallback, for
``depth == 0`` included.  The tree arrives as ``SampleTree``'s one
contiguous node stack, so nothing is concatenated or padded per call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import descend_score_ref

#: the largest R the kernel takes: Q (R x R float32) must fit in one SM's
#: shared memory next to one leaf row per warp (``csrc/spec_round.cu``)
MAX_R = 224


#: launches of the CUDA kernel by ``descend_score`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0

def _lib():
    lib = _build.load("spec_round")
    fn = lib.descend_score_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def descend_score(nodes: torch.Tensor, W: torch.Tensor, block: int,
                  q: torch.Tensor, us: torch.Tensor):
    """Per-round tree descent + leaf scoring for N proposal lanes.

    nodes: (2^(depth+1) - 1, R, R) stacked tree levels (root first); W:
    (2^depth * block, R) leaf rows; q: (N, R, R) projectors; us: (N, >=
    depth) descent uniforms.  Returns (block ids (N,) int64, raw unclamped
    scores (N, block) float32); the caller owns the clamp and the
    categorical draw.
    """
    m, r = W.shape
    n_blocks = m // block
    if block <= 0 or m % block or n_blocks & (n_blocks - 1):
        raise ValueError(f"W rows {m} must be a power-of-two number of "
                         f"blocks of {block}")
    depth = n_blocks.bit_length() - 1
    n = q.shape[0]
    if (tuple(nodes.shape) != (2 * n_blocks - 1, r, r)
            or tuple(q.shape) != (n, r, r) or us.dim() != 2
            or us.shape[0] != n or us.shape[1] < depth):
        raise ValueError(f"shape mismatch: nodes {tuple(nodes.shape)}, W "
                         f"{tuple(W.shape)}, q {tuple(q.shape)}, us "
                         f"{tuple(us.shape)}")
    devs = {t.device for t in (nodes, W, q, us)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = W.device
    if dev.type == "cpu":
        return descend_score_ref(nodes, W, block, q, us)
    if dev.type != "cuda":
        raise ValueError(f"descend_score runs on cpu or cuda, not {dev}")
    if r > MAX_R:
        raise ValueError(f"descend_score keeps Q on chip and takes R <= "
                         f"{MAX_R}; got R = {r}")
    for name, t in (("nodes", nodes), ("W", W), ("q", q), ("us", us)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    blk = torch.empty(n, dtype=torch.int64, device=dev)
    scores = torch.empty((n, block), dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(nodes.data_ptr(), W.data_ptr(), q.data_ptr(),
                        us.data_ptr(), us.shape[1], n, depth, block, r,
                        blk.data_ptr(), scores.data_ptr(), stream),
                     "descend_score")
    global launches
    launches += 1
    return blk, scores

