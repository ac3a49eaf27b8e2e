"""Shared helpers of the port's tests: carry reference state (a sampler, a
catalog version, a spectral form, a pool of MCMC chains) across to
``repro_torch`` as numpy, and pin the key layout of the golden files.

Importing it caps torch's CPU threads at this process's share of the
cores (the cores over ``PYTEST_XDIST_WORKER_COUNT``, at least 1): under
pytest-xdist every worker would otherwise start a thread per core, and
the workers' threads contend (one catalog draw: 6.3 s alone, 15 s each
with six at once at one thread, over 900 s each with six at once at
eight).  Every ``test_torch_*.py`` imports it.  It imports JAX only where
a helper needs it, so that the card's tests, on a machine without JAX,
can import it too."""
import contextlib
import os

import numpy as np
import torch

from repro_torch.convert import (
    catalog_state_from_numpy,
    mcmc_states_from_numpy,
    sampler_from_numpy,
)
from repro_torch.core.types import SpectralNDPP

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


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
    import jax

    with jax.threefry_partitionable(False):
        yield


def port_catalog_state(st, device="cpu"):
    """The reference ``CatalogState``'s arrays as the port's, bit for bit."""
    prop = st.proposal
    t = prop.tree
    return catalog_state_from_numpy(
        st.version, st.proposal_version, st.m, np.asarray(st.sp.Z),
        np.asarray(st.sp.sigma), np.asarray(prop.sp.Z),
        np.asarray(prop.sp.sigma), np.asarray(t.lam), np.asarray(prop.u),
        np.asarray(t.W), [np.asarray(lv) for lv in t.levels], t.block,
        device=device)


def port_spectral(sp, device="cpu"):
    """The reference ``SpectralNDPP`` as the port's, bit for bit."""
    return SpectralNDPP(Z=torch.as_tensor(np.array(sp.Z)).to(device),
                        sigma=torch.as_tensor(np.array(sp.sigma)).to(device))


def port_mcmc_states(states, device="cpu"):
    """A reference ``MCMCState`` pool (leading chain dim) as the port's."""
    return mcmc_states_from_numpy(
        np.asarray(states.items), np.asarray(states.mask),
        np.asarray(states.minv), np.asarray(states.step), device=device)
