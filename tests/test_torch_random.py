"""The port's threefry2x32 key schedule against ``jax.random``.

Every case runs in both key layouts, ``jax_threefry_partitionable=False``
(the layout of the golden files) and ``True`` (jax's default), set alike on
both sides.  Every function must be bit-exact with the reference: keys, raw
bits and uniforms compare as uint32 words, categorical and randint draws as
integers.  Only the Gumbel and normal noise go through ``log`` and
``erfinv``, whose last bits differ between XLA and PyTorch; they are
compared with a tolerance of a few float32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's CPU threads)

from repro_torch import random as trandom


@pytest.fixture(autouse=True, params=[False, True],
                ids=["partitionable_false", "partitionable_true"])
def _layout(request):
    """Both layouts, on both sides, scoped to the test."""
    with jax.threefry_partitionable(request.param), \
            trandom.threefry_partitionable(request.param):
        yield request.param


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


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_bits_at(n):
    """Words at chosen flat positions equal ``jax.random.bits``'s there."""
    key = jax.random.fold_in(jax.random.PRNGKey(16), 3)
    want = _u32(jax.random.bits(key, (n,), jnp.uint32))
    pos = np.arange(n)[::3][::-1].copy()
    got = trandom.bits_at(_t(key), n, torch.as_tensor(pos))
    assert (_u32(got) == want[pos]).all()


def test_normal_close():
    """Uniform words bit-exact underneath; erfinv's last bits differ."""
    keys = jax.random.split(jax.random.PRNGKey(17), 32)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (65,)))(keys))
    got = trandom.normal(_t(keys), (65,)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 1000), (3, 4),
                                   (-2**31, 2**31 - 1)])
def test_randint(lo, hi):
    keys = jax.random.split(jax.random.PRNGKey(18), 16)
    want = jax.vmap(lambda k: jax.random.randint(k, (33,), lo, hi))(keys)
    got = trandom.randint(_t(keys), (33,), lo, hi)
    assert (got.numpy() == np.asarray(want)).all()
