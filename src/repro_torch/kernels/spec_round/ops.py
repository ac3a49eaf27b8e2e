"""Dispatcher for the fused round descent + leaf scoring kernel (port of
``repro/kernels/spec_round/ops.py::descend_score``).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/spec_round.cu`` or raises — there is no fallback, for
``depth == 0`` included.  The tree arrives as ``SampleTree``'s one
contiguous node stack, so nothing is concatenated or padded per call.  The
kernel runs each lane on a cluster of ``cluster_size(N, SMs)`` CTAs.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import descend_score_ref

#: the largest R the kernel takes: Q (R x R float32) must fit in one SM's
#: shared memory next to the 32 leaf rows it stages (``csrc/spec_round.cu``)
MAX_R = 224

#: the most CTAs a lane's cluster takes (the portable cluster size)
MAX_CLUSTER = 8

#: launches of the CUDA kernel by ``descend_score`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0

_LAUNCH = None
_SMS = {}


def cluster_size(n: int, sms: int) -> int:
    """CTAs a lane for ``n`` lanes on a card of ``sms`` SMs: the largest
    power of two <= MAX_CLUSTER with n * c <= sms, and at least 1."""
    c = MAX_CLUSTER
    while c > 1 and n * c > sms:
        c //= 2
    return c


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _lib():
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("spec_round").descend_score_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def max_active_clusters(cluster: int, r: int, dev: torch.device) -> int:
    """How many clusters of ``cluster`` CTAs at R = ``r`` the card ``dev``
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.load("spec_round").descend_score_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(fn(cluster, r, ctypes.byref(out)),
                     "descend_score occupancy")
    return out.value


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
                        cluster_size(n, _sm_count(dev)), blk.data_ptr(),
                        scores.data_ptr(), stream),
                     "descend_score")
    global launches
    launches += 1
    return blk, scores

