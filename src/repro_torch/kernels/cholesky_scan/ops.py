"""Dispatcher for the Cholesky sampler's scan kernel (the port's own: the
reference's ``core/cholesky.py::sample_cholesky_inner`` is a ``lax.scan``,
not a Pallas kernel).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches ``csrc/cholesky_scan.cu`` or raises — there is no fallback.  Both
of the kernel's routes run one draw a CTA with the draw's R x R state on
chip for the whole scan, so N draws fill the card's SMs once N reaches
their count.  ``route(R)`` picks one by R alone: "blocked" (a block of
``BLOCK`` items at a time, its products on the tensor cores in 3xTF32; Q
in shared memory beside the block's operands; ``ref.
cholesky_scan_blocked_ref`` computes it in the kernel's order) up to
``BLOCKED_MAX_R``, "resident" (one item at a time on the FMA pipe; Q's
first 128 columns in registers) up to ``MAX_R``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import cholesky_scan_ref

#: the largest R the kernel takes: the resident route's Q rows sit in 14
#: register slots of each of a CTA's 16 warps, at the cap of 128 registers
MAX_R = 224

#: the items the blocked route decides a block at a time
BLOCK = 32

#: the largest R of the blocked route: Q (4 R^2 bytes) and the block's
#: operand pair (8 BLOCK R bytes, R rounded up to 16) fill a CTA's 227 KB
BLOCKED_MAX_R = 208

ROUTES = ("blocked", "resident")

#: launches of the CUDA kernel by ``cholesky_scan`` since the count was last
#: set to 0 (plain-version calls on CPU tensors do not count)
launches = 0
#: the same count by route (``route``): each launch adds one to its
#: route's count and to ``launches``
blocked_launches = 0
resident_launches = 0

_LAUNCH = {}


def route(r: int) -> str:
    """The kernel's design at width ``r``: "blocked" up to
    ``BLOCKED_MAX_R``, "resident" up to ``MAX_R``.  Wider states have no
    route yet: they need Q split over a cluster's CTAs (ROADMAP, Queue
    2b)."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"cholesky_scan keeps each draw's R x R state on one "
                         f"SM and takes 1 <= R <= {MAX_R}; got R = {r}")
    return "blocked" if r <= BLOCKED_MAX_R else "resident"


def _lib(name: str):
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load("cholesky_scan"), f"cholesky_scan_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def _check(Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor) -> None:
    if Z.dim() != 2 or tuple(W.shape) != (Z.shape[1],) * 2 \
            or u.dim() != 2 or u.shape[1] != Z.shape[0]:
        raise ValueError(f"shape mismatch: Z {tuple(Z.shape)}, W "
                         f"{tuple(W.shape)}, u {tuple(u.shape)}")
    devs = {t.device for t in (Z, W, u)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def cholesky_scan(Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """The sequential inclusion scan for N draws at once.

    Z: (M, R) item rows; W: (R, R) the inner matrix every draw starts from;
    u: (N, M) the draws' uniforms, all float32.  Returns (take (N, M) bool,
    p (N, M) float32 marginals), as ``ref.cholesky_scan_ref``.
    """
    _check(Z, W, u)
    dev = Z.device
    if dev.type == "cpu":
        return cholesky_scan_ref(Z, W, u)
    if dev.type != "cuda":
        raise ValueError(f"cholesky_scan runs on cpu or cuda, not {dev}")
    return _launch(route(Z.shape[1]), Z, W, u)


def _launch(name: str, Z: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """``cholesky_scan``'s launch on a route, for CUDA tensors
    (``chip_smoke.py`` and ``tools/cholesky_scan_times.py`` also run the
    resident route at R <= ``BLOCKED_MAX_R``, on the same inputs)."""
    _check(Z, W, u)
    if Z.device.type != "cuda":
        raise ValueError(f"a route runs on cuda, not {Z.device}")
    m, r = Z.shape
    route(r)
    if name not in ROUTES or (name == "blocked" and r > BLOCKED_MAX_R):
        raise ValueError(f"no route {name!r} at R = {r}")
    for t_name, t in (("Z", Z), ("W", W), ("u", u)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{t_name} must be a contiguous float32 tensor")
    dev = Z.device
    n = u.shape[0]
    take = torch.empty((n, m), dtype=torch.bool, device=dev)
    p = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return take, p
    fn = _lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(Z.data_ptr(), W.data_ptr(), u.data_ptr(), m, r, n,
                        take.data_ptr(), p.data_ptr(), stream),
                     f"cholesky_scan ({name})")
    global launches, blocked_launches, resident_launches
    launches += 1
    if name == "blocked":
        blocked_launches += 1
    else:
        resident_launches += 1
    return take, p
