"""Counter-based threefry2x32 keys, bit-exact with ``jax.random``.

Every draw of the sampler is keyed by its position (proposal ``t`` of a
request is ``fold_in(request_key, t)``), so the port must reproduce the
reference's key schedule exactly, not merely its distribution: a stateful
``torch.Generator`` would tie draws to the batching schedule.  This module
is the reference's ``jax._src.prng`` threefry2x32 implementation, written
with torch integer ops so it runs on any device, in either layout of
``jax_threefry_partitionable``:

- ``False`` (this module's default; the layout that wrote the reference's
  golden files): ``split`` and ``random_bits`` hash the counts
  0 .. 2n - 1 cut in two halves, word pairs (i, half + i);
- ``True`` (jax 0.5's default onwards): they hash the 64-bit position of
  each output as its (high, low) word pair; ``split`` keeps both output
  words as the new key, ``random_bits`` their xor.

``fold_in`` is the same in both.  ``threefry_partitionable(flag)`` sets
the layout for a block, as ``jax.threefry_partitionable`` does; it is not
thread-safe.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
every function takes a batch of keys (leading dims ``...``) and treats each
key independently, as ``jax.vmap`` over the reference function would.
uint32 arithmetic is int64 arithmetic masked to the low 32 bits.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000          # bit pattern of float32 1.0
_F32_NMANT = 23
_F32_TINY = float(np.finfo(np.float32).tiny)

Shape = Union[int, Sequence[int]]


#: the layout of ``jax_threefry_partitionable`` the functions below follow
_partitionable = False


@contextlib.contextmanager
def threefry_partitionable(flag: bool) -> Iterator[None]:
    """Follow ``jax_threefry_partitionable=flag`` inside the block."""
    global _partitionable
    old, _partitionable = _partitionable, bool(flag)
    try:
        yield
    finally:
        _partitionable = old


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 block hash (20 rounds) on broadcastable uint32
    words held in int64 tensors.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def _hash_counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))`` per key (the ``False`` layout): the
    count vector is cut in two halves (zero-padded to even length), hashed
    as word pairs, and the two output halves concatenated.
    keys (..., 2) -> (..., n)."""
    half = (n + 1) // 2
    count = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    if n % 2:
        count[-1] = 0
    k1 = keys[..., 0:1]
    k2 = keys[..., 1:2]
    a, b = threefry2x32(k1, k2, count[:half], count[half:])
    return torch.cat([a, b], dim=-1)[..., :n]


def _hash_positions(keys: torch.Tensor, pos: torch.Tensor):
    """Both output words of ``threefry2x32(key, (pos >> 32, pos & mask))``
    (the ``True`` layout's ``iota_2x32_shape`` counts) for positions
    ``pos`` (int64, 1-D) per key: keys (..., 2) -> two (..., len(pos))."""
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], pos >> 32,
                        pos & _MASK)


def as_key(key, device=None) -> torch.Tensor:
    """Raw key(s) as an int64 ``(..., 2)`` tensor (accepts numpy uint32
    keys as the reference's ``jax.random.PRNGKey`` returns them)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.int64), device=device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under 32-bit JAX: the seed is an int32,
    and the key is ``[seed >> 32, seed & 0xFFFFFFFF]`` with the high word
    always 0 (a logical shift of a 32-bit value by 32)."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 31):
        raise OverflowError(f"seed {s} does not fit the int32 seed of 32-bit "
                            f"JAX keys")
    return torch.tensor([0, s & _MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` per key: (..., 2) -> (..., num, 2)."""
    if _partitionable:  # _threefry_split_foldlike
        pos = torch.arange(num, dtype=torch.int64, device=keys.device)
        return torch.stack(_hash_positions(keys, pos), dim=-1)
    bits = _hash_counts(keys, 2 * num)
    return bits.reshape(tuple(keys.shape[:-1]) + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per key: keys (..., 2), data an integer or an
    integer tensor broadcastable to ``keys.shape[:-1]`` (taken mod 2^32,
    as the reference casts it to uint32).  Returns (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit ``random_bits`` per key: (..., 2) -> (..., *shape) uint32
    words in int64."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    if _partitionable:  # _threefry_random_bits_partitionable
        pos = torch.arange(n, dtype=torch.int64, device=keys.device)
        a, b = _hash_positions(keys, pos)
        bits = a ^ b
    else:
        bits = _hash_counts(keys, n)
    return bits.reshape(tuple(keys.shape[:-1]) + shape)


def bits_at(key: torch.Tensor, n: int, pos: torch.Tensor) -> torch.Tensor:
    """The words at flat positions ``pos`` (int64, each < n) of
    ``random_bits(key, (n,))`` for one key (2,), without the other
    positions, so that a large draw can be made in slices, each bit-equal
    to the whole.  In the ``True`` layout position p is the xor of the
    two words of the counter pair (p >> 32, p & mask).  In the ``False``
    layout p < half = ceil(n/2) is the first output word of the counter
    pair (p, half + p), a later p the second word of (p - half, p); for
    odd n the last pair's second counter is 0."""
    if _partitionable:
        a, b = threefry2x32(key[0], key[1], pos >> 32, pos & _MASK)
        return a ^ b
    half = (n + 1) // 2
    first = pos < half
    x1 = torch.where(first, pos, pos - half)
    x2 = torch.where(first, pos + half, pos)
    if n % 2:
        x2 = torch.where(x2 == n, torch.zeros_like(x2), x2)
    a, b = threefry2x32(key[0], key[1], x1, x2)
    return torch.where(first, a, b)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``'s float32 map of 32-bit words: the top 23
    bits become the mantissa of a float in [1, 2), minus 1, then scaled
    into [minval, maxval) in float32 exactly as the reference does."""
    fbits = (bits >> (32 - _F32_NMANT)) | _ONE_F32_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) per key (``uniform_from_bits`` of
    the key's ``random_bits``)."""
    return uniform_from_bits(random_bits(keys, shape), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s map ("low" mode) of 32-bit words:
    ``-log(-log(u))`` with ``u`` uniform on [tiny, 1)."""
    u = uniform_from_bits(bits, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode."""
    return gumbel_from_bits(random_bits(keys, shape))


def bernoulli(keys: torch.Tensor, p: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` ("low" mode): ``uniform < p`` in float32."""
    return uniform(keys, shape) < torch.tensor(p, dtype=torch.float32,
                                               device=keys.device)


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) erfinv(u)`` with ``u``
    uniform on (-1, 1).  ``torch.erfinv`` and XLA's may differ in the last
    bits, so draws agree to float32 rounding, not bit for bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, minval=lo, maxval=1.0)
    return torch.erfinv(u) * torch.tensor(np.sqrt(2), dtype=torch.float32,
                                          device=keys.device)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    keys (..., 2), logits (..., C) -> (...,) int64 — the Gumbel-argmax
    (first maximum on ties, as ``jnp.argmax``)."""
    g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def randint(keys: torch.Tensor, shape: Shape, minval: int,
            maxval: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.randint`` (int32) per key: (..., 2) -> (..., *shape)
    int64 values in [minval, maxval).

    The reference's arithmetic, not a plain modulo: the key is split in
    two, each half draws 32 random bits, and with ``span = maxval - minval``
    the offset is ``((hi % span) * (2^32 % span) + lo % span) % span`` in
    wrapping uint32 arithmetic (``2^32 % span`` taken as
    ``((2^16 % span)^2) % span``, the square wrapping too).
    ``maxval <= minval`` returns ``minval``.

    ``maxval`` may be an integer tensor broadcastable to
    ``keys.shape[:-1] + shape``: each key then draws below its own bound,
    as ``jax.vmap`` of the reference over keys and bounds does (its values
    are int32 by type, so they need no range check).
    """
    lo_i32, hi_i32 = -(1 << 31), (1 << 31) - 1
    tensor_max = isinstance(maxval, torch.Tensor)
    if not (lo_i32 <= minval <= hi_i32
            and (tensor_max or lo_i32 <= maxval <= hi_i32)):
        raise OverflowError(f"randint bounds [{minval}, {maxval}) must fit "
                            f"int32, as the reference's default dtype")
    k = split(keys)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    if tensor_max:
        mx = maxval.to(device=keys.device, dtype=torch.int64)
        span = torch.where(mx > minval, (mx - minval) & _MASK,
                           torch.ones_like(mx))
        mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    else:
        span = (maxval - minval) & _MASK if maxval > minval else 1
        mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    # int32 addition, wrapping as the reference's does
    return ((minval + offset + (1 << 31)) & _MASK) - (1 << 31)
