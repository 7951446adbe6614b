"""Threefry-2x32, as ``jax.random`` computes it, over int64 tensors.

The reference draws its cell-keyed replica jitter with JAX's default
generator (``jax_threefry_partitionable`` on, the default since JAX 0.5).
This module computes the same bits, so the port's representatives equal
the reference's bit for bit without the reference's draws being handed
over.

A key is a pair ``(k0, k1)`` of int64 tensors holding uint32 values, of
any equal shape: a key tensor of shape (K,) is K keys, and every function
below batches over it (``jax.vmap`` over keys).  ``torch.uint32`` lacks
``<<`` on the CPU, so each 32-bit word is an int64 tensor in [0, 2**32),
masked back after every add and shift.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

Key = Tuple[torch.Tensor, torch.Tensor]   # (k0, k1), int64 holding uint32

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds, five key injections)
    of the counter pairs ``(x0, x1)`` under ``key``; key and counters
    broadcast against each other."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> Key:
    """``jax.random.key(seed)`` for a 32-bit seed: ``(0, seed)``."""
    def word(v):
        return torch.tensor(v, dtype=torch.int64, device=device)
    return word(0), word(seed & MASK32)


def _counters(k: Key, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the counter pairs ``(0, 0..n-1)`` under each key of
    ``k``: the partitionable scheme's split and bits.  (S + (n,)) each."""
    ctr = torch.arange(n, dtype=torch.int64, device=k[0].device)
    return threefry2x32((k[0][..., None], k[1][..., None]),
                        torch.zeros_like(ctr), ctr)


def split(k: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(k, num)``, partitionable: key i is threefry of
    the counter pair ``(0, i)``."""
    b0, b1 = _counters(k, num)
    return tuple((b0[..., i], b1[..., i]) for i in range(num))


def fold_in(k: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in(k, data)`` for uint32 ``data`` held in an
    int64 tensor: threefry of ``(0, data)``.  A (K,) ``data`` gives K keys
    (the reference's ``vmap`` over cells)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k[0].device)
    return threefry2x32(k, torch.zeros_like(data), data & MASK32)


def bits(k: Key, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (32-bit, partitionable): the XOR of
    the two words of threefry over the counters ``(0, 0..n-1)``.  A key
    of shape S gives S + shape."""
    b0, b1 = _counters(k, math.prod(shape))
    return (b0 ^ b1).reshape(*k[0].shape, *shape)


def uniform(k: Key, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0 give u in [1, 2), less 1, then
    ``u * (maxval - minval) + minval``, floored at ``minval``.

    XLA fuses that multiply-add into one rounding (measured on XLA:CPU:
    at a span of 0.2 two float32 roundings differ from it in the last
    bit of half the draws).  Here the product is exact in float64 (24 by
    24 significant bits), and so is the sum whenever ulp(minval) lies
    within [2**-28, 2**5] × ulp(maxval − minval), as for a span
    symmetric about 0 or a ``minval`` of 0: then the one rounding to
    float32 is the fused one."""
    f = ((bits(k, shape) >> 9) | 0x3F800000).to(torch.int32)
    u = f.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    span = (hi - lo).double()
    return torch.maximum(lo, (u.double() * span + lo.double()).float())
