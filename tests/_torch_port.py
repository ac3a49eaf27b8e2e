"""Shared helpers of the port's tests: carry a reference sampler across to
``repro_torch`` as numpy, and pin the key layout of the golden files."""
import contextlib

import jax
import numpy as np

from repro_torch.convert import sampler_from_numpy


def port_sampler(sampler, device="cpu"):
    """The reference ``NDPPSampler``'s state as the port's, bit for bit."""
    t = sampler.tree
    return sampler_from_numpy(
        np.asarray(sampler.sp.Z), np.asarray(sampler.sp.sigma),
        np.asarray(t.lam), np.asarray(t.W), [np.asarray(lv) for lv in t.levels],
        t.block, t.M, device=device)


@contextlib.contextmanager
def golden_key_layout():
    """The threefry layout the reference's golden files were written in
    (``jax_threefry_partitionable=False``), scoped to the block so other
    test files in the same worker keep JAX's default."""
    with jax.threefry_partitionable(False):
        yield
