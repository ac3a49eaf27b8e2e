"""The port's threefry2x32 key schedule against ``jax.random``.

Every function must be bit-exact with the reference under the key layout of
the golden files (``jax_threefry_partitionable=False``): keys, raw bits and
uniforms compare as uint32 words, categorical draws as indices.  Only the
Gumbel noise goes through ``log``, whose last bit differs between XLA and
PyTorch; it is compared with a tolerance of a few float32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import golden_key_layout
from repro_torch import random as trandom


@pytest.fixture(autouse=True)
def _layout():
    with golden_key_layout():
        yield


def _t(key):
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_prng_key(seed):
    assert (_u32(trandom.PRNGKey(seed)) == _u32(jax.random.PRNGKey(seed))).all()


@pytest.mark.parametrize("num", [1, 2, 3, 8, 200])
def test_split(num):
    key = jax.random.PRNGKey(42)
    got = trandom.split(trandom.PRNGKey(42), num)
    assert (_u32(got) == _u32(jax.random.split(key, num))).all()


def test_split_batched():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    want = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
    assert (_u32(trandom.split(_t(keys), 7)) == _u32(want)).all()


@pytest.mark.parametrize("data", [0, 1, 5, 123456789, 2**32 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(9)
    want = jax.random.fold_in(key, np.uint32(data))
    assert (_u32(trandom.fold_in(trandom.PRNGKey(9), data)) == _u32(want)).all()


def test_fold_in_batched():
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    data = np.arange(6, dtype=np.uint32) * 1000 + 17
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data))
    got = trandom.fold_in(_t(keys), torch.as_tensor(data.astype(np.int64)))
    assert (_u32(got) == _u32(want)).all()


@pytest.mark.parametrize("shape", [(), (1,), (5,), (14,), (3, 4)])
def test_random_bits(shape):
    key = jax.random.PRNGKey(11)
    want = jax.random.bits(key, shape, jnp.uint32)
    assert (_u32(trandom.random_bits(trandom.PRNGKey(11), shape))
            == _u32(want)).all()


@pytest.mark.parametrize("shape", [(), (1,), (5,), (14,), (3, 4)])
def test_uniform(shape):
    key = jax.random.PRNGKey(12)
    want = np.asarray(jax.random.uniform(key, shape))
    got = trandom.uniform(trandom.PRNGKey(12), shape).numpy()
    assert got.dtype == np.float32
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


def test_uniform_minval_batched():
    keys = jax.random.split(jax.random.PRNGKey(13), 64)
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (9,), minval=tiny, maxval=1.0))(keys))
    got = trandom.uniform(_t(keys), (9,), minval=tiny, maxval=1.0).numpy()
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


def test_gumbel_close():
    keys = jax.random.split(jax.random.PRNGKey(14), 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (33,)))(keys))
    got = trandom.gumbel(_t(keys), (33,)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)


@pytest.mark.parametrize("n_cat", [1, 2, 8, 64])
def test_categorical(n_cat):
    keys = jax.random.split(jax.random.PRNGKey(15), 256)
    logits = np.random.default_rng(n_cat).normal(
        size=(256, n_cat)).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    got = trandom.categorical(_t(keys), torch.as_tensor(logits))
    assert (got.numpy() == np.asarray(want)).all()
