"""Deterministic synthetic LM data (port of ``repro/data/lm.py::lm_batch``).

Every batch is a pure function of (seed, step, host).  Tokens follow a
Zipfian unigram distribution with short-range repetition structure so the
LM loss has learnable signal.  The draws use the port's threefry
(``repro_torch.random``), so under the reference's golden key layout
(``jax_threefry_partitionable=False``) the tokens and labels equal the
reference's.

``jax.random.categorical(k1, logp, shape=(b, s + 1))`` is ONE key's Gumbel
noise of shape (b, s + 1, V) and an argmax over V.  At a full vocabulary
that is 1.25e9 words for 2 x 4,097 tokens, so the port draws it in slices
of whole rows (``random.bits_at``), each bit-equal to the same rows of the
whole draw, and keeps only each row's argmax: the transient memory is one
slice's, not 15-25 GB.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import random as trandom
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig

#: Gumbel words drawn at once (whole rows of V): ~2^25, a few hundred MB of
#: int64 temporaries
SLICE_WORDS = 1 << 25


def zipf_logits(vocab: int, device=None) -> torch.Tensor:
    """The unigram log-weights -1.1 log(rank), rank = 1..V, float32."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -torch.log(ranks) * 1.1


def categorical_rows(key: torch.Tensor, logits: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(rows,))`` for logits
    (V,): the Gumbel-argmax of one (rows, V) draw, made in slices of whole
    rows.  Returns (rows,) int64."""
    v = logits.shape[0]
    n = rows * v
    per = max(1, SLICE_WORDS // v)
    out = torch.empty(rows, dtype=torch.int64, device=logits.device)
    for r0 in range(0, rows, per):
        r1 = min(rows, r0 + per)
        pos = torch.arange(r0 * v, r1 * v, dtype=torch.int64,
                           device=logits.device)
        g = trandom.gumbel_from_bits(trandom.bits_at(key, n, pos))
        out[r0:r1] = torch.argmax(g.view(r1 - r0, v) + logits, dim=-1)
    return out


def lm_batch(cfg: ModelConfig, seed: int, step: int, batch: int,
             seq_len: int, host: int = 0, n_hosts: int = 1,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"} (b, seq_len) int32 (+ "input_embeds" for the
    vlm and audio frontend stubs), b = batch / n_hosts, on ``device``."""
    assert batch % n_hosts == 0
    dev = resolve_device(device)
    b_local = batch // n_hosts
    key = trandom.fold_in(trandom.fold_in(trandom.PRNGKey(seed, dev), step),
                          host)
    k1, k2, k3 = trandom.split(key, 3)
    # Zipf-ish unigram draw via exponential race
    logp = zipf_logits(cfg.vocab, dev)
    toks = categorical_rows(k1, logp, b_local * (seq_len + 1)).view(
        b_local, seq_len + 1)
    # splice in learnable bigram structure: with p=0.3, next = (prev*7)%V
    rep = trandom.bernoulli(k2, 0.3, (b_local, seq_len + 1))
    deterministic = (toks * 7 + 11) % cfg.vocab
    shifted = torch.roll(deterministic, 1, dims=1)
    toks = torch.where(rep, shifted, toks).to(torch.int32)
    batch_out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("vlm", "audio"):
        batch_out["input_embeds"] = (
            trandom.normal(k3, (b_local, seq_len, cfg.d_model)) * 0.02
        ).to(cfg.activation_dtype)
    return batch_out
