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


# ---------------------------------------------------------------- normal
# XLA:CPU's f32 math, as ``jax.random.normal`` reaches it (erf_inv): each
# step is one f32 rounding, and where LLVM contracts a multiply with the
# add that is its only use, the pair is one fused multiply-add.  Both are
# computed here in float64 and rounded once to float32 (a 24 by 24 bit
# product is exact in float64).

def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 ``x`` to float32 and back."""
    return x.float().double()


def _fma(a, b, c) -> torch.Tensor:
    return _f32(a * b + c)


def _c(v: float) -> float:
    """A literal as the f32 constant XLA folds it to."""
    return float(torch.tensor(v, dtype=torch.float32))


_LOG_P = tuple(_c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG1P_NUM = tuple(_c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# Giles' erfinv polynomials, for w < 5 and w >= 5
_ERFINV_LO = tuple(_c(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_HI = tuple(_c(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log of positive normal float32 values x (held in
    float64): the Cephes polynomial after splitting off the exponent."""
    bits = x.float().view(torch.int32)
    e = ((bits >> 23) - 0x7F).double() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32).double()
    small = m < _c(0.707106781186547524)
    e = e - small.double()
    m = _f32((m - 1.0) + torch.where(small, m, 0.0))
    m2 = _f32(m * m)
    m3 = _f32(m2 * m)
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _f32(_c(-2.12194440e-4) * e))
    t = _f32(_fma(-0.5, m2, m) + y)
    return _fma(_c(0.693359375), e, t)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p for x > -1 (float64-held float32): a
    Cephes rational function below |x| = sqrt(2) - 1, log(1 + x) above."""
    x2 = _f32(x * x)
    small = _f32(_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = _f32(_f32(x * x2) * small)
    small = _f32(x + _fma(-0.5, x2, small))
    large = _log_f32(_f32(torch.clamp(x + 1.0, min=2.0 ** -126)))
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` on float32 as XLA:CPU computes it (Giles'
    polynomial, float32 roundings and fused multiply-adds as there):
    ``torch.special.erfinv`` agrees in only a third of the bits."""
    xd = x.double()
    w = -_log1p_f32(_f32(-(xd * xd)))
    lt = w < 5.0
    w = torch.where(lt, _f32(w - 2.5),
                    _f32(_f32(torch.sqrt(w.clamp(min=0))) - 3.0))
    lo = torch.tensor(_ERFINV_LO, dtype=torch.float64, device=x.device)
    hi = torch.tensor(_ERFINV_HI, dtype=torch.float64, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LO)):
        p = _fma(p, w, torch.where(lt, lo[i], hi[i]))
    out = _f32(p * xd).float()
    return torch.where(x.abs() == 1, x * math.inf, out)


def normal(k: Key, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: √2 · erfinv(u) of
    u = ``uniform(k, shape, nextafter(-1, 0), 1)``, bit for bit."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return _c(math.sqrt(2.0)) * erfinv_f32(u)
