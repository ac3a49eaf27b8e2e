"""Synthetic datasets of the paper (port of ``repro/data/baskets.py``;
Section 6.2): the feature generator of the runtime experiments and the
planted basket generators of the learning experiments.

"We first sample x_1..x_100 ~ N(0, I_{2K}/(2K)), and integers t_1..t_100
from Poisson(5), rescaled so sum_i t_i = M.  Next, we draw t_i random
vectors from N(x_i, I_{2K}), and assign the first K dims as rows of V and
the latter as rows of B."  Used for Fig. 2's runtime curves.

For the learning experiments (Table 2) ``planted_baskets`` and
``hothead_baskets`` generate observed baskets from a planted kernel, so
that MPR has signal.  All three are the reference's numpy generators,
draw for draw: the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.learning import Baskets
from ..device import DeviceLike, resolve_device


def synthetic_features(m: int, k: int, seed: int = 0, n_clusters: int = 100
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-uniform features (V (m, k), B (m, k), D (k, k)) as float32 numpy
    arrays, draw for draw the reference generator's output."""
    rng = np.random.default_rng(seed)
    n_clusters = min(n_clusters, m)
    centers = rng.normal(size=(n_clusters, 2 * k)) / np.sqrt(2 * k)
    t = rng.poisson(5.0, size=n_clusters).astype(np.float64) + 1e-9
    t = np.maximum(np.round(t * m / t.sum()).astype(int), 0)
    # fix rounding so counts sum to m
    t[0] += m - t.sum()
    rows = [centers[i] + rng.normal(size=(ti, 2 * k))
            for i, ti in enumerate(t) if ti > 0]
    z = np.concatenate(rows, axis=0)[:m]
    d = rng.normal(size=(k, k))
    return (z[:, :k].astype(np.float32), z[:, k:].astype(np.float32),
            d.astype(np.float32))


def _split_baskets(items: np.ndarray, mask: np.ndarray,
                   device: DeviceLike) -> Tuple[Baskets, Baskets]:
    """The first 90% as the training baskets, the rest as the test ones."""
    dev = resolve_device(device)
    n_train = int(0.9 * items.shape[0])

    def part(sl):
        return Baskets(torch.from_numpy(items[sl].astype(np.int64)).to(dev),
                       torch.from_numpy(mask[sl]).to(dev))

    return part(slice(None, n_train)), part(slice(n_train, None))


def planted_baskets(m: int, n_baskets: int, k_max: int = 8, seed: int = 0,
                    n_topics: int = 32, style: str = "topic", *,
                    device: DeviceLike = None, **hothead_kwargs
                    ) -> Tuple[Baskets, Baskets]:
    """(train, test) padded baskets on ``device`` (default ``cuda``) from a
    topic model with signed pairwise interactions: positively correlated
    item pairs exist, which NDPPs can capture and symmetric DPPs cannot.

    ``style="hothead"`` switches to ``hothead_baskets`` (shaped by
    ``n_pairs`` / ``p_head`` / ``p_comp`` / ``p_noise``, passed through);
    overriding ``k_max`` or ``n_topics`` with it is an error."""
    if style == "hothead":
        if k_max != 8 or n_topics != 32:
            raise ValueError(
                "k_max/n_topics configure the topic generator and do not "
                "apply to style='hothead' (its width is 2*n_pairs + 2) — "
                "pass n_pairs/p_head/p_comp/p_noise instead")
        return hothead_baskets(m, n_baskets, seed=seed, device=device,
                               **hothead_kwargs)
    if style != "topic":
        raise ValueError(f"unknown planted-basket style {style!r}")
    if hothead_kwargs:
        raise ValueError(f"unexpected arguments for style='topic': "
                         f"{sorted(hothead_kwargs)}")
    rng = np.random.default_rng(seed)
    topic_of = rng.integers(0, n_topics, size=m)
    # companion map: item i attracts item comp[i] (positive correlation)
    comp = (np.arange(m) + m // 2) % m
    items = np.zeros((n_baskets, k_max), np.int32)
    mask = np.zeros((n_baskets, k_max), np.float32)
    for n in range(n_baskets):
        size = rng.integers(2, k_max + 1)
        topic = rng.integers(0, n_topics)
        pool = np.flatnonzero(topic_of == topic)
        if len(pool) < size:
            pool = np.arange(m)
        chosen = list(rng.choice(pool, size=size // 2 + 1, replace=False))
        # attract companions
        for i in list(chosen):
            if len(chosen) >= size:
                break
            if rng.random() < 0.6:
                c = comp[i]
                if c not in chosen:
                    chosen.append(c)
        while len(chosen) < size:
            c = int(rng.integers(0, m))
            if c not in chosen:
                chosen.append(c)
        chosen = chosen[:size]
        items[n, : len(chosen)] = chosen
        mask[n, : len(chosen)] = 1.0
    return _split_baskets(items, mask, device)


def hothead_baskets(m: int, n_baskets: int, n_pairs: int = 2,
                    p_head: float = 0.99, p_comp: float = 0.15,
                    p_noise: float = 0.05, seed: int = 0, *,
                    device: DeviceLike = None) -> Tuple[Baskets, Baskets]:
    """(train, test) baskets on ``device`` whose max-likelihood NDPP kernel
    has an arbitrarily large rejection rate.

    Items ``2j`` (j < n_pairs) are hot heads present in almost every basket
    (``p_head``); item ``2j + 1`` is the head's companion and occurs only
    beside it (``p_comp``); the other items are rare independent noise
    (``p_noise``).  Empty baskets are kept.  The per-pair max-likelihood
    block ``[[a, s], [-s, 0]]`` has proposal ratio ``(1+a+s)(1+s)/(1+a+s^2)
    -> 1 + s`` as ``a`` grows, so the unconstrained NDPP's expected trials
    pass the ONDPP rank bound ``2^(K/2)``."""
    rng = np.random.default_rng(seed)
    if m < 2 * n_pairs + 1:
        raise ValueError(f"m={m} too small for {n_pairs} head/companion pairs")
    k_max = 2 * n_pairs + 2
    items = np.zeros((n_baskets, k_max), np.int32)
    mask = np.zeros((n_baskets, k_max), np.float32)
    for n in range(n_baskets):
        row = []
        for q in range(n_pairs):
            if rng.random() < p_head:
                row.append(2 * q)
                if rng.random() < p_comp:
                    row.append(2 * q + 1)
        noise = np.flatnonzero(
            rng.random(m - 2 * n_pairs) < p_noise) + 2 * n_pairs
        row += list(noise[: k_max - len(row)])
        items[n, : len(row)] = row
        mask[n, : len(row)] = 1.0
    return _split_baskets(items, mask, device)
