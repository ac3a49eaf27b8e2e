"""Synthetic feature generator of the paper's runtime experiments (port of
``repro/data/baskets.py::synthetic_features``; Section 6.2).

"We first sample x_1..x_100 ~ N(0, I_{2K}/(2K)), and integers t_1..t_100
from Poisson(5), rescaled so sum_i t_i = M.  Next, we draw t_i random
vectors from N(x_i, I_{2K}), and assign the first K dims as rows of V and
the latter as rows of B."
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
