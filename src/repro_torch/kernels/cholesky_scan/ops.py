"""Dispatcher for the Cholesky sampler's scan kernel (the port's own: the
reference's ``core/cholesky.py::sample_cholesky_inner`` is a ``lax.scan``,
not a Pallas kernel).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/cholesky_scan.cu`` or raises — there is no fallback.  The
kernel runs one draw a CTA with the draw's R x R state on chip for the
whole scan (its first 128 columns in registers, the rest in shared
memory), so N draws fill the card's SMs once N reaches their count.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import cholesky_scan_ref

#: the largest R the kernel takes: Q's rows sit in 14 register slots of each
#: of a CTA's 16 warps, at the cap of 128 registers a thread
MAX_R = 224

#: launches of the CUDA kernel by ``cholesky_scan`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0

_LAUNCH = None


def route(r: int) -> str:
    """The kernel's design at width ``r``: "resident" (each draw's Q on one
    SM for the whole scan) up to ``MAX_R``.  Wider states have no route
    yet: they need Q split over a cluster's CTAs (ROADMAP, Queue 2b)."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"cholesky_scan keeps each draw's R x R state on one "
                         f"SM and takes 1 <= R <= {MAX_R}; got R = {r}")
    return "resident"


def _lib():
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("cholesky_scan").cholesky_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def cholesky_scan(Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """The sequential inclusion scan for N draws at once.

    Z: (M, R) item rows; W: (R, R) the inner matrix every draw starts from;
    u: (N, M) the draws' uniforms, all float32.  Returns (take (N, M) bool,
    p (N, M) float32 marginals), as ``ref.cholesky_scan_ref``.
    """
    if Z.dim() != 2 or tuple(W.shape) != (Z.shape[1],) * 2 \
            or u.dim() != 2 or u.shape[1] != Z.shape[0]:
        raise ValueError(f"shape mismatch: Z {tuple(Z.shape)}, W "
                         f"{tuple(W.shape)}, u {tuple(u.shape)}")
    devs = {t.device for t in (Z, W, u)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = Z.device
    if dev.type == "cpu":
        return cholesky_scan_ref(Z, W, u)
    if dev.type != "cuda":
        raise ValueError(f"cholesky_scan runs on cpu or cuda, not {dev}")
    m, r = Z.shape
    route(r)
    for name, t in (("Z", Z), ("W", W), ("u", u)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    n = u.shape[0]
    take = torch.empty((n, m), dtype=torch.bool, device=dev)
    p = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return take, p
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), W.data_ptr(), u.data_ptr(), m, r, n,
                        take.data_ptr(), p.data_ptr(), stream),
                     "cholesky_scan")
    global launches
    launches += 1
    return take, p
