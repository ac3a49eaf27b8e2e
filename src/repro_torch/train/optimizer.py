"""Optimizers (port of ``repro/train/optimizer.py``): AdamW with two
full-precision moments, Adafactor with factored second moments of >=2D
params, gradient compression and global-norm clipping.

Parameters, gradients and state are dictionaries name -> tensor (the
model's ``named_parameters()``).  The update math is the reference's, in
float32, but unlike the reference's pure functions ``update`` writes the
new parameters and moments in place (``copy_`` and in-place moment
updates): at 2B parameters a second copy of the model and its moments
would not leave room for the activations.  It returns the same dictionaries.
The reference's ``state_axes`` (logical sharding axes) waits for a mesh.

``moment_dtype`` trades optimizer memory for precision (bf16 moments halve
state bytes; update math is always f32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # gradient compression applied before the optimizer (bf16 | int8 | none)
    grad_compression: str = "none"


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def _global_norm(grads: Tensors) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(sum(leaves))


def _clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    if max_norm <= 0:
        return grads
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


def compress_grads(grads: Tensors, mode: str) -> Tensors:
    """Cast/quantize gradients as the data-parallel all-reduce would move
    them: bf16, or int8 with a per-tensor scale and symmetric rounding,
    decoded straight back to float32."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    if mode == "int8":
        def q(g):
            gf = g.float()
            scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
            qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            return qi.float() * scale
        return {k: q(g) for k, g in grads.items()}
    raise ValueError(mode)


def make_adamw(cfg: OptimizerConfig) -> Optimizer:
    mdt = getattr(torch, cfg.moment_dtype)

    def init(params: Tensors):
        dev = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors):
        grads = compress_grads(grads, cfg.grad_compression)
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        stepf = step.float()
        # float32 powers, as the reference's b ** step.astype(float32)
        bc1 = 1.0 - torch.tensor(cfg.b1, device=stepf.device) ** stepf
        bc2 = 1.0 - torch.tensor(cfg.b2, device=stepf.device) ** stepf
        for k, p in params.items():
            gf = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - cfg.lr * delta)
            m.copy_(mf)
            v.copy_(vf)
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def make_adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018, simplified)."""

    def _factored(p) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2

    def init(params: Tensors):
        def one(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, device=p.device)}

        dev = next(iter(params.values())).device
        return {"v": {k: one(p) for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors):
        grads = compress_grads(grads, cfg.grad_compression)
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        beta = 1.0 - step.float() ** -0.8
        for k, p in params.items():
            gf = grads[k].float()
            v = state["v"][k]
            g2 = gf * gf + 1e-30
            if _factored(p):
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rms_r = vr / torch.mean(vr, dim=-1, keepdim=True)
                precond = (rms_r[..., None] * vc[..., None, :]) ** -0.5
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
                precond = v["v"] ** -0.5
            u = gf * precond
            # update clipping (Adafactor's d=1.0 rule)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u, min=1.0)
            newp = p.float() - cfg.lr * u
            if cfg.weight_decay:
                newp = newp - cfg.lr * cfg.weight_decay * p.float()
            p.copy_(newp)
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return make_adamw(cfg)
    if cfg.name == "adafactor":
        return make_adafactor(cfg)
    raise ValueError(cfg.name)
