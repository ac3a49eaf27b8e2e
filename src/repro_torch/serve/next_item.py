"""Conditioned next-item serving over a learned NDPP kernel; port of
``repro/serve/next_item.py``.

The serving half of the learning pipeline (``train.ndpp`` is the other
half): given a partial basket J, serve either

  * greedy scores, ``det(L_{J u i}) / det(L_J)`` for every candidate item
    at once (one Schur-complement inner matrix and one launch of the
    ``bilinear`` kernel over all M rows), or
  * sampled completions, exact draws from the NDPP conditioned on
    ``J ⊆ Y`` (an NDPP over the complement with inner matrix W_J, drawn by
    the ``cholesky_scan`` kernel),

plus the paper's MPR evaluation over held-out baskets against the
item-popularity baseline.  It takes the ``ONDPPParams`` / ``NDPPParams``
that ``train.ndpp.fit_*`` returns and serves on their device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import random as trandom
from ..core.cholesky import sample_cholesky_inner
from ..core.learning import Baskets, item_frequencies
from ..core.map_inference import (
    _scores,
    _zx,
    conditional_rows,
    mean_percentile_rank,
    mpr_frequency_baseline,
)
from ..core.types import NDPPParams, ONDPPParams


@dataclasses.dataclass
class MPRReport:
    """Paired MPR evaluation (the same held-out draws for both rows)."""

    model: float       # learned-kernel MPR (100 = held item always on top)
    frequency: float   # item-popularity baseline MPR
    n_baskets: int

    @property
    def lift(self) -> float:
        return self.model - self.frequency


class NextItemServer:
    """Basket-completion front end over a learned NDPP kernel.

    Args:
      params: the learned kernel, ``ONDPPParams`` (converted by
        ``to_general``) or ``NDPPParams``; it serves on their device.
      k_pad: conditioning capacity; partial baskets are padded to this
        many slots so every call has one shape.
    """

    def __init__(self, params: Union[NDPPParams, ONDPPParams],
                 k_pad: int = 16):
        if isinstance(params, ONDPPParams):
            params = params.to_general()
        self.params = params
        self.k_pad = int(k_pad)
        self.device = params.V.device
        # Z = [V, B] and X, built once for every call
        self._z, self._x = _zx(params)

    @property
    def M(self) -> int:
        return self.params.M

    def _pad(self, basket: Sequence[int]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        basket = np.asarray(basket, np.int64).reshape(-1)
        if basket.size > self.k_pad:
            raise ValueError(
                f"basket of {basket.size} items exceeds k_pad={self.k_pad}")
        if basket.size and (basket.min() < 0 or basket.max() >= self.M):
            raise ValueError(f"item ids must be in [0, {self.M})")
        obs = np.full((self.k_pad,), -1, np.int64)
        obs[: basket.size] = basket
        m = np.zeros((self.k_pad,), np.float32)
        m[: basket.size] = 1.0
        return (torch.from_numpy(obs).to(self.device),
                torch.from_numpy(m).to(self.device))

    # ------------------------------------------------------------ greedy
    def scores(self, basket: Sequence[int]) -> torch.Tensor:
        """(M,) conditional gains ``det(L_{J u i})/det(L_J)`` on the
        server's device; observed items score -inf."""
        return _scores(self._z, self._x, *self._pad(basket))

    def top_k(self, basket: Sequence[int], k: int) -> np.ndarray:
        """The k best next items by conditional gain, best first; fewer when
        the basket leaves fewer valid candidates (observed items are never
        recommended back)."""
        s = self.scores(basket)
        vals, order = torch.sort(s, descending=True, stable=True)
        order = order[torch.isfinite(vals)][:k]
        return order.cpu().numpy()

    # ----------------------------------------------------------- sampled
    def _draw(self, basket: Sequence[int], keys: torch.Tensor
              ) -> torch.Tensor:
        z_c, w_marg = conditional_rows(self._z, self._x, *self._pad(basket))
        return sample_cholesky_inner(z_c, w_marg, keys)

    def complete(self, basket: Sequence[int], key) -> np.ndarray:
        """One exact draw of completion items from ``P(Y | J ⊆ Y)``: the
        sampled item ids (J itself excluded)."""
        key = trandom.as_key(key, self.device)
        return np.flatnonzero(self._draw(basket, key).cpu().numpy())

    def complete_many(self, basket: Sequence[int], key, n: int
                      ) -> List[np.ndarray]:
        """``n`` i.i.d. completions, draw i keyed by ``split(key, n)[i]``:
        one (n, M) scan launch and one transfer to the host."""
        keys = trandom.split(trandom.as_key(key, self.device), n)
        taken = self._draw(basket, keys).cpu().numpy()
        return [np.flatnonzero(t) for t in taken]

    # -------------------------------------------------------------- eval
    def evaluate_mpr(self, test: Baskets, key,
                     train: Optional[Baskets] = None) -> MPRReport:
        """Held-one-out MPR of the learned kernel against the
        item-popularity baseline on the same held-out draws.  ``train``
        gives the frequency table (by default ``test`` counts itself)."""
        freq = item_frequencies(train if train is not None else test, self.M)
        model = float(mean_percentile_rank(self.params, test.items,
                                           test.mask, key))
        base = float(mpr_frequency_baseline(freq, test.items, test.mask,
                                            key))
        return MPRReport(model=model, frequency=base,
                         n_baskets=int(test.items.shape[0]))
