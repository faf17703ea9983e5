"""Counter-based threefry2x32 random numbers, bit-identical to ``jax.random``.

The simulator's results depend on its random draws bit for bit: table
tie-breaks, initial layer picks and flowlet re-rolls all decide flow
completion times.  This module reproduces jax's default generator
(``threefry2x32`` with ``jax_threefry_partitionable=True``) in plain
tensor integer arithmetic, so the port draws exactly the numbers the
JAX package draws, on any device.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words.
uint32 arithmetic is emulated in int64 and masked to 32 bits after every
add and shift (torch's uint32 support is partial).

* :func:`PRNGKey` — ``jax.random.PRNGKey`` for an integer seed.
* :func:`split`, :func:`fold_in` — key derivation; :func:`fold_in` also
  takes a batch of keys (``vmap(fold_in)`` in the JAX package).
* :func:`uniform` — float32 U[0, 1) of a given shape; a batch of keys
  gives one block per key (``vmap(uniform)``).
* :func:`permutation` — ``jax.random.permutation`` of ``arange(n)``.

In partitionable mode the counter of output element ``i`` is the 64-bit
flat index ``i`` split into (high, low) words, so a draw depends on the
whole requested shape, exactly as in jax.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from . import resolve_device

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "permutation", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

DeviceLike = Union[str, torch.device, None]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block function (20 rounds) on broadcastable
    int64 tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def PRNGKey(seed: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a 32-bit seed becomes ``[0, seed]``
    (two's complement low word for negative seeds), a wider one its high
    and low words.  On the card unless ``device`` says otherwise (raises
    without one, as every entry point does)."""
    seed = int(seed)
    if -2 ** 31 <= seed < 2 ** 31:
        words = [0, seed & _MASK]
    else:
        words = [(seed >> 32) & _MASK, seed & _MASK]
    return torch.tensor(words, dtype=torch.int64,
                        device=resolve_device(device))


def _keywords(key: torch.Tensor):
    return key[..., 0:1], key[..., 1:2]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` for one key, and
    ``(B, num, 2)`` for a batch of keys ``(B, 2)``, each split alone."""
    k1, k2 = _keywords(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` is ``(2,)`` or a batch ``(B, 2)``,
    ``data`` an int or an int tensor broadcastable against the batch."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & _MASK
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words of ``shape`` (partitionable layout).  A batch
    of keys ``(B, 2)`` gives ``(B, *shape)``, one block per key."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = _keywords(key)
    a, b = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (a ^ b).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 U[0, 1) as ``jax.random.uniform``: the top 23 bits become
    the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    out = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(out, 0.0)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` shuffled by
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds (one up to n = 1625, two up to
    about 2.6 million), each splitting the key, drawing 32-bit sort keys
    from the subkey and sorting by them stably.  int64, on the key's
    device."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(float(_MASK))))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
