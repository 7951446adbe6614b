"""Strongly-universal hash families over 64-bit keys (Thorup's vector
multiply-shift), on int64-carried uint32 limbs.

For a 64-bit key split into two 32-bit words (x_hi, x_lo) and uniform
64-bit parameters (a1, a2, b),

    h(x) = (a1 * x_hi  +  a2 * x_lo  +  b)  >> (64 - l)      in [0, 2**l)

The sign hash is the same family with l = 1, mapped to {-1, +1}.  Bit for
bit the reference's ``repro.core.hashing`` given the same parameters.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng, u64


class MulShiftParams(NamedTuple):
    """Parameters of R independent hashes: six (R,) int64 tensors holding
    uint32 values; (a1, a2, b) are 64-bit values as hi/lo limb pairs."""
    a1_hi: torch.Tensor
    a1_lo: torch.Tensor
    a2_hi: torch.Tensor
    a2_lo: torch.Tensor
    b_hi: torch.Tensor
    b_lo: torch.Tensor

    @property
    def rows(self) -> int:
        return self.a1_hi.shape[0]

    def to(self, device) -> "MulShiftParams":
        return MulShiftParams(*[p.to(device) for p in self])


def make_params(key: prng.Key, rows: int) -> MulShiftParams:
    """Draw R independent hash functions' parameters on the key's device:
    the reference's ``jax.random.bits(key, (6, R), uint32)``, computed by
    ``prng.bits`` in int64 words, so every device draws the same bits."""
    return MulShiftParams(*prng.bits(key, (6, rows)).unbind(0))


def _accumulate(params: MulShiftParams, key_hi: torch.Tensor,
                key_lo: torch.Tensor) -> u64.U64:
    """(a1*x_hi + a2*x_lo + b) mod 2**64, (R, 1) x (items,) -> (R, items)."""
    t1 = u64.mul_u32((params.a1_hi[:, None], params.a1_lo[:, None]),
                     key_hi[None, :])
    t2 = u64.mul_u32((params.a2_hi[:, None], params.a2_lo[:, None]),
                     key_lo[None, :])
    return u64.add(u64.add(t1, t2), (params.b_hi[:, None],
                                     params.b_lo[:, None]))


def hashes(params: MulShiftParams, key_hi: torch.Tensor,
           key_lo: torch.Tensor, log2_buckets: int):
    """(items,) 64-bit keys -> (R, items) buckets in [0, 2**l) and
    (R, items) signs in {-1, +1}, from one accumulation."""
    if not 1 <= log2_buckets <= 32:
        raise ValueError(f"log2_buckets must be in [1, 32], got {log2_buckets}")
    hi, _ = _accumulate(params, key_hi, key_lo)
    return hi >> (32 - log2_buckets), 1 - 2 * (hi >> 31)


def bucket_hash(params: MulShiftParams, key_hi: torch.Tensor,
                key_lo: torch.Tensor, log2_buckets: int) -> torch.Tensor:
    return hashes(params, key_hi, key_lo, log2_buckets)[0]


def sign_hash(params: MulShiftParams, key_hi: torch.Tensor,
              key_lo: torch.Tensor) -> torch.Tensor:
    return hashes(params, key_hi, key_lo, 1)[1]
