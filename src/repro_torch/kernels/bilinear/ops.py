"""Dispatchers for the batched quadratic-form kernels (port of
``repro/kernels/bilinear/ops.py``): ``bilinear`` (one inner matrix for
all rows), ``bilinear_sharded`` (the same over a mesh) and
``bilinear_batched`` (one inner matrix per batch element).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/bilinear.cu`` or raises — there is no fallback.
``bilinear``'s kernel (``csrc/quad_form.cuh``, shared with ``score_all``)
has two routes, which the CUDA source chooses by R alone: "resident" up to
R = 224, "panel" above.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...models import sharding as msh
from .ref import bilinear_batched_ref, bilinear_ref

#: the largest R ``bilinear`` takes: quad_form.cuh's panel route stages a
#: 64-row tile and a 32-column panel of W in float32 (400 R bytes of shared
#: memory)
MAX_R = 512

#: the largest R ``bilinear_batched`` takes: csrc/bilinear.cu stages a CTA's
#: 32 rows in shared memory (128 R bytes of at most 232,448)
BATCHED_MAX_R = 1816

#: launches of the CUDA kernel by ``bilinear`` (and ``bilinear_sharded``,
#: one per shard) since the count was last set to 0; plain-version calls
#: on CPU tensors do not count
launches = 0
#: ``bilinear``'s launches by route (``bilinear_route`` in the CUDA source):
#: each launch adds one to its route's count and to ``launches``
resident_launches = 0
panel_launches = 0
#: the same count for ``bilinear_batched``
batched_launches = 0


def _lib():
    """The launcher and the route it takes at a width R (1 "resident")."""
    lib = _build.load("bilinear")
    fn = lib.bilinear_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    route = lib.bilinear_route
    route.argtypes, route.restype = [ctypes.c_int], ctypes.c_int
    return fn, route


def _batched_lib():
    lib = _build.load("bilinear")
    fn = lib.bilinear_batched_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bilinear(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """p_i = z_i^T W z_i for every row of Z (M, R) against W (R, R), both
    float32 or both bfloat16, accumulated and returned in float32 (M,).
    A row's score does not depend on the other rows, so a slice of Z
    scores to the same bits as the whole."""
    if Z.dim() != 2 or tuple(W.shape) != (Z.shape[1],) * 2:
        raise ValueError(f"shape mismatch: Z {tuple(Z.shape)}, W "
                         f"{tuple(W.shape)}")
    if Z.device != W.device:
        raise ValueError(f"Z on {Z.device}, W on {W.device}")
    dev = Z.device
    if dev.type == "cpu":
        return bilinear_ref(Z, W)
    if dev.type != "cuda":
        raise ValueError(f"bilinear runs on cpu or cuda, not {dev}")
    m, r = Z.shape
    if r > MAX_R:
        raise ValueError(f"bilinear stages a row tile and a panel of W on "
                         f"chip and takes R <= {MAX_R}; got R = {r}")
    if Z.dtype != W.dtype or Z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Z and W must both be float32 or both bfloat16, "
                         f"not {Z.dtype} and {W.dtype}")
    if not (Z.is_contiguous() and W.is_contiguous()):
        raise ValueError("Z and W must be contiguous")
    out = torch.empty(m, dtype=torch.float32, device=dev)
    fn, route_of = _lib()
    route = "resident" if route_of(r) else "panel"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), W.data_ptr(), out.data_ptr(), m, r,
                        int(Z.dtype == torch.bfloat16), stream),
                     f"bilinear ({route})")
    global launches, resident_launches, panel_launches
    launches += 1
    if route == "resident":
        resident_launches += 1
    else:
        panel_launches += 1
    return out


def bilinear_sharded(Z: msh.Rows, W: torch.Tensor, mesh) -> torch.Tensor:
    """``bilinear`` over a mesh: every shard scores only its own (M/S, R)
    rows against W, so the (M, R) rows stay on their devices.  ``Z`` is a
    ``ShardedRows`` on ``mesh`` or a plain (M, R) tensor, split evenly (M
    must divide over the mesh).  Returns the (M,) scores gathered on the
    mesh's first device, bit-equal to ``bilinear(Z, W)``."""
    parts = msh.row_parts(Z, mesh)
    return torch.cat([bilinear(p, W.to(d)).to(mesh.device)
                      for p, d in zip(parts, mesh.devices)])


def bilinear_batched(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """p_{n,b} = z_{n,b}^T W_n z_{n,b}: Z (N, B, R) rows and W (N, R, R)
    inner matrices, float32 -> (N, B) float32.  The kernel runs the FMA
    chains of ``descend_score``'s leaf stage (``csrc/leaf_score.cuh``) in
    their order, 8 rows a warp, so the scores of a block equal that
    kernel's raw scores of the block bit for bit."""
    if Z.dim() != 3 or tuple(W.shape) != (Z.shape[0], Z.shape[2], Z.shape[2]):
        raise ValueError(f"shape mismatch: Z {tuple(Z.shape)}, W "
                         f"{tuple(W.shape)}")
    if Z.device != W.device:
        raise ValueError(f"Z on {Z.device}, W on {W.device}")
    dev = Z.device
    if dev.type == "cpu":
        return bilinear_batched_ref(Z, W)
    if dev.type != "cuda":
        raise ValueError(f"bilinear_batched runs on cpu or cuda, not {dev}")
    for name, t in (("Z", Z), ("W", W)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    n, b, r = Z.shape
    if r > BATCHED_MAX_R:
        raise ValueError(f"bilinear_batched stages its rows on chip and "
                         f"takes R <= {BATCHED_MAX_R}; got R = {r}")
    out = torch.empty((n, b), dtype=torch.float32, device=dev)
    fn = _batched_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), W.data_ptr(), out.data_ptr(), n, b, r,
                        stream), "bilinear_batched")
    global batched_launches
    batched_launches += 1
    return out
