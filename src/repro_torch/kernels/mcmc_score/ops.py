"""Dispatcher for the MCMC all-candidate scorer (port of
``repro/kernels/mcmc_score/ops.py::score_all``, unsharded).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/mcmc_score.cu`` or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import score_all_ref

#: the largest R the kernel takes: a 64-row tile of Z and a 32-column panel
#: of A_c (400 R bytes) must fit in one CTA's shared memory
MAX_R = 512

#: launches of the CUDA kernel by ``score_all`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0


def _lib():
    lib = _build.load("mcmc_score")
    fn = lib.score_all_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), A.data_ptr(), out.data_ptr(), m, c, r,
                        stream), "score_all")
    global launches
    launches += 1
    return out
