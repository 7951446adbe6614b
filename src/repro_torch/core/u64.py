"""64-bit unsigned arithmetic as uint32 limb pairs carried in int64.

The reference keeps every 64-bit quantity (cell keys, hash parameters,
hash accumulators) as a pair of uint32 arrays ``(hi, lo)``.  PyTorch's
``torch.uint32`` lacks ``<<`` on the CPU, so here each limb is an int64
tensor holding a value in [0, 2**32), and every result is masked back to
32 bits.  All ops are modular (mod 2**64) and match numpy uint64
semantics bit for bit.

A U64 value is a ``(hi, lo)`` tuple of equal-shaped int64 tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

U64 = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), int64 holding uint32

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def from_numpy(x) -> torch.Tensor:
    """uint32 numpy array -> int64 limb tensor."""
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def add(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    hi = (a[0] + b[0] + (lo >> 32)) & MASK32
    return hi, lo & MASK32


def add_u32(a: U64, x: torch.Tensor) -> U64:
    lo = a[1] + x
    return (a[0] + (lo >> 32)) & MASK32, lo & MASK32


def umul32_full(x: torch.Tensor, y: torch.Tensor) -> U64:
    """Full 64-bit product of two uint32 values, via 16-bit limbs (the
    reference's construction: every intermediate fits in 32 bits)."""
    xl, xh = x & _MASK16, x >> 16
    yl, yh = y & _MASK16, y >> 16
    t = xl * yl
    w0 = t & _MASK16
    k = t >> 16
    t = xh * yl + k
    w1 = t & _MASK16
    w2 = t >> 16
    t = xl * yh + w1
    k = t >> 16
    lo = ((t << 16) | w0) & MASK32
    hi = (xh * yh + w2 + k) & MASK32
    return hi, lo


def mul_lo32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2**32 of two uint32 values without leaving int64:
    x·y_lo16 < 2**48 and only the low 16 bits of x·y_hi16 survive the
    shift by 16."""
    return (x * (y & _MASK16) + (((x * (y >> 16)) & _MASK16) << 16)) & MASK32


def mul_u32(a: U64, x: torch.Tensor) -> U64:
    """(64-bit a) * (32-bit x) mod 2**64."""
    hi1, lo1 = umul32_full(a[1], x)
    return (hi1 + mul_lo32(a[0], x)) & MASK32, lo1


def shr(a: U64, s: int) -> U64:
    """Logical right shift by a static amount s in [0, 64)."""
    if s == 0:
        return a
    if s < 32:
        lo = ((a[1] >> s) | (a[0] << (32 - s))) & MASK32
        return a[0] >> s, lo
    return torch.zeros_like(a[0]), a[0] >> (s - 32)


def shl(a: U64, s: int) -> U64:
    """Left shift by a static amount s in [0, 64)."""
    if s == 0:
        return a
    if s < 32:
        hi = ((a[0] << s) | (a[1] >> (32 - s))) & MASK32
        return hi, (a[1] << s) & MASK32
    return (a[1] << (s - 32)) & MASK32, torch.zeros_like(a[1])


def sort_key(a: U64) -> torch.Tensor:
    """One int64 per key whose signed order is the unsigned (hi, lo)
    order: the sign bit of hi is flipped (hi − 2**31), so no shift can
    overflow.  Stands in for ``jnp.lexsort((lo, hi))`` under a stable
    sort."""
    return (a[0] - (1 << 31)) * (1 << 32) + a[1]
