"""Dispatchers for the MCMC all-candidate scorer (port of
``repro/kernels/mcmc_score/ops.py``): ``score_all`` and its mesh
versions ``score_all_sharded`` and ``score_argmax_sharded``.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/mcmc_score.cu`` or raises — there is no fallback.  The
kernel (``csrc/quad_form.cuh``) has two routes, which the CUDA source
chooses by R alone: "resident" up to R = 224, "panel" above.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...models import sharding as msh
from .ref import score_all_ref

#: the largest R the kernel takes: its panel route stages a 64-row tile of
#: Z and a 32-column panel of A_c (400 R bytes) in one CTA's shared memory
MAX_R = 512

#: launches of the CUDA kernel by ``score_all`` (one per shard in the
#: sharded scorers) since the count was last set to 0 (plain-version calls
#: on CPU tensors do not count)
launches = 0
#: the same count by route (``score_all_route`` in the CUDA source): each
#: launch adds one to its route's count and to the total above
resident_launches = 0
panel_launches = 0


def _lib():
    lib = _build.load("mcmc_score")
    fn = lib.score_all_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    route = lib.score_all_route
    route.argtypes, route.restype = [ctypes.c_int], ctypes.c_int
    return fn, route


def score_all(Z: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """s_{c,m} = z_m^T A_c z_m for every item m and chain c.

    Z: (M, R) float32 ground-set rows, A: (C, R, R) float32 per-chain score
    matrices -> (C, M) float32 move scores (add ratios, or swap ratios when
    A is a swap score matrix).
    """
    if Z.dim() != 2 or A.dim() != 3 or tuple(A.shape[1:]) != (Z.shape[1],) * 2:
        raise ValueError(f"shape mismatch: Z {tuple(Z.shape)}, A "
                         f"{tuple(A.shape)}")
    if Z.device != A.device:
        raise ValueError(f"Z on {Z.device}, A on {A.device}")
    dev = Z.device
    if dev.type == "cpu":
        return score_all_ref(Z, A)
    if dev.type != "cuda":
        raise ValueError(f"score_all runs on cpu or cuda, not {dev}")
    m, r = Z.shape
    c = A.shape[0]
    if r > MAX_R:
        raise ValueError(f"score_all keeps a row tile and a panel of A on "
                         f"chip and takes R <= {MAX_R}; got R = {r}")
    if c > 65535:
        raise ValueError(f"score_all takes at most 65535 chains; got {c}")
    for name, t in (("Z", Z), ("A", A)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    out = torch.empty((c, m), dtype=torch.float32, device=dev)
    fn, route_of = _lib()
    route = "resident" if route_of(r) else "panel"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), A.data_ptr(), out.data_ptr(), m, c, r,
                        stream),
                     f"score_all ({route})")
    global launches, resident_launches, panel_launches
    launches += 1
    if route == "resident":
        resident_launches += 1
    else:
        panel_launches += 1
    return out


def score_all_sharded(Z: msh.Rows, A: torch.Tensor, mesh) -> torch.Tensor:
    """``score_all`` over a mesh: each shard scores only its own (M/S, R)
    rows.  A row's score does not depend on M or on the row's place, so the
    values are bit-equal to the unsharded scorer.  ``Z`` is a
    ``ShardedRows`` on ``mesh`` or a plain (M, R) tensor split evenly (M
    must divide over the mesh).  Returns (C, M), gathered on the mesh's
    first device."""
    parts = msh.row_parts(Z, mesh)
    return torch.cat([score_all(p, A.to(d)).to(mesh.device)
                      for p, d in zip(parts, mesh.devices)], dim=1)


def score_argmax_sharded(Z: msh.Rows, A: torch.Tensor, mesh):
    """Best candidate per chain without gathering (C, M) anywhere: each
    shard reduces its own scores to one (C,) winner and only the (S, C)
    per-shard winners are gathered and reduced.  Ties go to the lowest
    shard, then the lowest row, as ``argmax`` over the whole row does.
    Returns (scores (C,), global item indices (C,))."""
    parts = msh.row_parts(Z, mesh)
    maxes, args = [], []
    for s, (p, d) in enumerate(zip(parts, mesh.devices)):
        sc = score_all(p, A.to(d))                                # (C, M/S)
        maxes.append(sc.max(dim=1).values.to(mesh.device))
        args.append((sc.argmax(dim=1) + s * p.shape[0]).to(mesh.device))
    all_max = torch.stack(maxes)                                  # (S, C)
    all_arg = torch.stack(args)
    win = all_max.argmax(dim=0)                                   # (C,)
    c = torch.arange(all_max.shape[1], device=mesh.device)
    return all_max[win, c], all_arg[win, c]
