"""Public SSD op (port of ``repro/kernels/ssd/ops.py``): ``ssd``, the
chunked Mamba2 scan, with a hand-written backward.

A tensor on the CPU goes to the plain version in ``ref.py``
(``ssd_chunked_ref``), differentiated by autograd.  A CUDA tensor launches
``csrc/ssd.cu`` through ``SSDScan`` (a forward kernel, and a backward
kernel in autograd's backward pass) or raises: a shape its tiles cannot
take raises, and there is no gate that quietly runs the plain version.
Forward and backward each have two routes, chosen by ``_fwd_route`` and
``_bwd_route`` from the dtype and shape alone by one rule (``_route``):
"wgmma" (bf16, chunk 64 or 128, N and P multiples of 16: three
chunk-parallel launches on the tensor cores) and "simt" (the rest: one
float32 kernel a (batch, head) that walks the chunks, in reverse for the
backward).

b and c may be read through a head stride of 0: ``models/mamba.py``
broadcasts one B and one C over all heads with ``expand``, and the kernel
reads them in place rather than materialize a copy a head.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssd_chunked_ref

#: the largest chunk, state size N and head dim P the kernel's tiles hold
MAX_CHUNK = 128
MAX_N = 128
MAX_P = 64

#: launches of the forward kernel since the count was last set to 0 (a
#: checkpointed layer's forward runs again in the backward and counts
#: again); plain-version calls on CPU tensors do not count
launches = 0
#: the same count by route (``_fwd_route``): each launch adds one to its
#: route's count and to ``launches``
wgmma_fwd_launches = 0
simt_fwd_launches = 0
#: launches of the backward kernel since the count was last set to 0
bwd_launches = 0
#: the same count by route (``_bwd_route``): each launch adds one to its
#: route's count and to ``bwd_launches``
wgmma_bwd_launches = 0
simt_bwd_launches = 0

_F = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_SERVING = ("comes with the LM serving slice (a state carried in from a "
            "cache); see ROADMAP.md, Queue 1")


def _fwd_lib():
    fn = _build.load("ssd").ssd_fwd_launch
    fn.argtypes = [_F] * 7 + [_I] * 6 + [_L] * 9 + [_I, _F]
    fn.restype = ctypes.c_int
    return fn


def _fwd_wgmma_lib():
    fn = _build.load("ssd").ssd_fwd_wgmma_launch
    fn.argtypes = [_F] * 7 + [_I] * 6 + [_L] * 9 + [_F]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = _build.load("ssd").ssd_bwd_launch
    fn.argtypes = [_F] * 11 + [_I] * 6 + [_L] * 12 + [_I, _F]
    fn.restype = ctypes.c_int
    return fn


def _bwd_wgmma_lib():
    fn = _build.load("ssd").ssd_bwd_wgmma_launch
    fn.argtypes = [_F] * 12 + [_I] * 6 + [_L] * 12 + [_F]
    fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype, chunk: int, n: int, p: int) -> str:
    """The kernels for a dtype and shape, forward and backward alike:
    "wgmma" (the tensor-core routes of ``csrc/ssd.cu``: bf16, 64-row chunk
    tiles, N and P in steps of 16) or "simt" (float32 products, every shape
    ``_check`` allows)."""
    if dtype == torch.bfloat16 and chunk % 64 == 0 and n % 16 == 0 \
            and p % 16 == 0:
        return "wgmma"
    return "simt"


#: the forward's route and the backward's: one rule (``_route``)
_fwd_route = _bwd_route = _route


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t (contiguous float32) at a 16-byte aligned address, for the wgmma
    route's float4 loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"want x (B, S, H, P), a (B, S, H), b = c "
                         f"(B, S, H, N); got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(a.shape) != (bsz, s, h) or tuple(b.shape[:3]) != (bsz, s, h):
        raise ValueError(f"x {tuple(x.shape)}, a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in (B, S, H)")
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"the kernel takes a chunk of 1..{MAX_CHUNK} that "
                         f"divides the sequence; got chunk {chunk}, S {s}")
    if p % 8 or not 0 < p <= MAX_P:
        raise ValueError(f"the kernel takes a head dim P that is a multiple "
                         f"of 8 up to {MAX_P}; got {p}")
    if not 0 < n <= MAX_N:
        raise ValueError(f"the kernel takes a state size N up to {MAX_N}; "
                         f"got {n}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            x.dtype == b.dtype == c.dtype):
        raise ValueError(f"x, b, c must all be float32 or all bfloat16, not "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"a must be float32, not {a.dtype}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError(f"x on {x.device}, a on {a.device}, b on "
                         f"{b.device}, c on {c.device}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t with a unit stride along its last axis (a view where it has one
    already; a broadcast head axis of stride 0 is kept)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def ssd_forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, keep_states: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """The forward kernel on CUDA tensors: (y like x, h_last (B, H, N, P)
    float32, and with ``keep_states`` every chunk's starting state
    (B, H, S/chunk, N, P) float32 for the backward, else None)."""
    _check(x, a, b, c, chunk)
    return _launch_forward(_fwd_route(x.dtype, chunk, b.shape[-1],
                                      x.shape[-1]),
                           x, a, b, c, chunk, keep_states)


def _launch_forward(route: str, x, a, b, c, chunk: int, keep_states: bool):
    """``ssd_forward``'s launch on a route, for checked arguments
    (``chip_smoke.py`` and ``tools/ssd_kernel_times.py`` run both routes
    on the same inputs)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, b, c, a = _rows(x), _rows(b), _rows(c), a.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    h_last = torch.empty((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
    # the wgmma route writes every chunk's starting state (its pass B's
    # carry), into a scratch when the caller keeps none
    states = (torch.empty((bsz, h, s // chunk, n, p), dtype=torch.float32,
                          device=x.device)
              if keep_states or route == "wgmma" else None)
    ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), h_last.data_ptr(),
            None if states is None else states.data_ptr())
    strides = (*_strides(x), *_strides(b), *_strides(c))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            code = _fwd_wgmma_lib()(*ptrs, bsz, s, h, p, n, chunk, *strides,
                                    stream)
        else:
            code = _fwd_lib()(*ptrs, bsz, s, h, p, n, chunk, *strides,
                              int(x.dtype == torch.bfloat16), stream)
        _build.check(code, f"ssd forward ({route})")
    global launches, wgmma_fwd_launches, simt_fwd_launches
    launches += 1
    if route == "wgmma":
        wgmma_fwd_launches += 1
    else:
        simt_fwd_launches += 1
    return y, h_last, states if keep_states else None


def ssd_backward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                 dh_last: Optional[torch.Tensor], chunk: int
                 ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel: (dx, da, db, dc) from the forward's inputs,
    its chunk-start states (``ssd_forward(..., keep_states=True)``), dy and
    the gradient of h_last (None for zero).  dx, db and dc come in x's, b's
    and c's dtype, da in float32, each shaped like its input (db and dc
    a head at a time, also where b and c broadcast one row over the
    heads: autograd's expand sums them)."""
    _check(x, a, b, c, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dy.shape) != (bsz, s, h, p):
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped like x "
                         f"{tuple(x.shape)}")
    if states is None or tuple(states.shape) != (bsz, h, s // chunk, n, p) \
            or states.dtype != torch.float32:
        raise ValueError(f"the backward takes the forward's float32 "
                         f"chunk-start states (B, H, S/chunk, N, P) = "
                         f"{(bsz, h, s // chunk, n, p)}")
    if dh_last is not None and (tuple(dh_last.shape) != (bsz, h, n, p)):
        raise ValueError(f"dh_last {tuple(dh_last.shape)} must be "
                         f"{(bsz, h, n, p)}")
    return _launch_backward(_bwd_route(x.dtype, chunk, n, p), x, a, b, c,
                            states, dy, dh_last, chunk)


def _launch_backward(route: str, x, a, b, c, states, dy, dh_last, chunk):
    """``ssd_backward``'s launch on a route, for checked arguments
    (``tools/ssd_kernel_times.py`` times both routes at one shape)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, b, c, a = _rows(x), _rows(b), _rows(c), a.contiguous()
    dy = _rows(dy.to(x.dtype))
    states = _aligned(states.contiguous())
    if dh_last is not None:
        dh_last = _aligned(dh_last.float().contiguous())
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    da = torch.empty((bsz, s, h), dtype=torch.float32, device=x.device)
    db = torch.empty((bsz, s, h, n), dtype=b.dtype, device=x.device)
    dc = torch.empty((bsz, s, h, n), dtype=c.dtype, device=x.device)
    ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            states.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
            da.data_ptr(), db.data_ptr(), dc.data_ptr())
    strides = (*_strides(x), *_strides(b), *_strides(c), *_strides(dy))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            # dH_end(q) of every chunk: the route's only scratch, float32
            dh_end = torch.empty((bsz, h, s // chunk, n, p),
                                 dtype=torch.float32, device=x.device)
            code = _bwd_wgmma_lib()(*ptrs, dh_end.data_ptr(), bsz, s, h, p,
                                    n, chunk, *strides, stream)
        else:
            code = _bwd_lib()(*ptrs, bsz, s, h, p, n, chunk, *strides,
                              int(x.dtype == torch.bfloat16), stream)
        _build.check(code, f"ssd backward ({route})")
    global bwd_launches, wgmma_bwd_launches, simt_bwd_launches
    bwd_launches += 1
    if route == "wgmma":
        wgmma_bwd_launches += 1
    else:
        simt_bwd_launches += 1
    return dx, da, db, dc


class SSDScan(torch.autograd.Function):
    """``ssd`` on the card: the forward kernel, saving its inputs and, when
    a gradient is wanted, every chunk's starting state; the backward kernel
    for dx, da, db and dc."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk: int):
        ctx.set_materialize_grads(False)
        keep = any(ctx.needs_input_grad[:4])
        y, h_last, states = ssd_forward(x, a, b, c, chunk, keep_states=keep)
        if keep:
            ctx.save_for_backward(x, a, b, c, states)
        ctx.chunk = chunk
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, a, b, c, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, da, db, dc = ssd_backward(x, a, b, c, states, dy, dh_last,
                                      ctx.chunk)
        return dx, da, db, dc, None


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        h0: Optional[torch.Tensor] = None, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan.  x: (B, S, H, P), a: (B, S, H), b/c: (B, S, H, N)
    -> (y like x, h_last (B, H, N, P) float32).

    CPU tensors: ``ssd_chunked_ref`` (with ``h0``, a carried-in state).
    CUDA tensors: the kernel, differentiable; ``h0`` belongs to the cache
    path of the LM serving slice, not ported yet (ROADMAP.md, Queue 1),
    and raises."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, a, b, c, h0, chunk=min(chunk, x.shape[1]))
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cpu or cuda, not {x.device}")
    if h0 is not None:
        raise NotImplementedError(f"ssd with h0 on the card {_SERVING}")
    return SSDScan.apply(x, a.float(), b, c, int(chunk))


def ssd_decode_step(*args, **kwargs):
    raise NotImplementedError(f"ssd_decode_step {_SERVING}")
