"""The train step (port of ``repro/train/steps.py::make_train_step``).

The reference's step is a pure function under ``jax.jit``; the port's runs
eagerly and updates the model's parameters and the optimizer state in
place (``optimizer.py``), returning them with the metrics.  The sharding
helpers, the prefill and the decode steps wait for a mesh and the LM
serving slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.model import LM, forward_hidden, lm_loss
from .optimizer import Optimizer


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None,
                    grad_accum: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm"})``.  ``grad_accum > 1`` splits the batch into
    microbatches and sums their gradients in float32, dividing by
    ``grad_accum`` at the end, as the reference's scan."""
    if mesh is not None:
        raise NotImplementedError("a train step on a mesh waits for the "
                                  "port's sharding of the LM; see "
                                  "ROADMAP.md, Queue 1")

    def loss_fn(model: LM, tokens, labels, embeds) -> torch.Tensor:
        h, _ = forward_hidden(cfg, model, tokens, input_embeds=embeds)
        return lm_loss(cfg, model, h, labels)

    def train_step(model: LM, opt_state, batch: Dict[str, torch.Tensor]):
        params = dict(model.named_parameters())
        leaves = list(params.values())
        embeds = batch.get("input_embeds")
        if grad_accum == 1:
            loss = loss_fn(model, batch["tokens"], batch["labels"], embeds)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        else:
            b = batch["tokens"].shape[0]
            assert b % grad_accum == 0
            mb = b // grad_accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                emb = embeds[sl] if embeds is not None else None
                l = loss_fn(model, batch["tokens"][sl], batch["labels"][sl],
                            emb)
                g = torch.autograd.grad(l, leaves)
                grads = [a + x for a, x in zip(grads, g)]
                loss = loss + l.detach()
            loss = loss / grad_accum
            grads = [g / grad_accum for g in grads]
        grads = dict(zip(params, grads))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
        _, opt_state = opt.update(grads, opt_state, params)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
