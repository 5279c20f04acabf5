"""Threefry-2x32 and the Gumbel draw of the reference's positional PRNG
stream, bit for bit, in torch.

The reference samples with ``jax.random`` (``repro/serving/sampling.py:
finalize_candidates``): slot ``b``'s noise for its ``n``-th emitted
token is ``gumbel(fold_in(PRNGKey(seed_b), n), (K,), float32)`` under
the partitionable threefry that ``repro/compat.py`` turns on (the
default of jax 0.9.0).  This module computes the same words:

* ``PRNGKey(seed)`` of a uint32 seed is the key ``(0, seed)``;
* ``fold_in(key, n)`` hashes the count pair ``(0, n)`` under ``key``:
  the new key is the hash's two output words;
* the random bits of element ``i`` of a 1-D shape hash ``(0, i)`` (the
  64-bit iota split into its high and low words) and XOR the two
  output words;
* a uniform float takes the top 23 bits as the mantissa of a number in
  ``[1, 2)``, subtracts 1, adds ``minval`` (the smallest normal f32 for
  the Gumbel draw) and clamps at it; the Gumbel value is
  ``−log(−log(u))``.

uint32 words live in int64 tensors, reduced to 32 bits where a result
depends on the high bits, so the arithmetic is the same on the CPU and
on CUDA, needs no host sync and captures into a CUDA graph.  Both
logarithms are taken in float64 and rounded to float32 after each, so
the card and the CPU give the same float32 values (``chip_smoke.py``
checks it on a grid of seeds and offsets); XLA's float32 ``log`` is an
approximation of its own, so a Gumbel value may differ from the
reference's by an ulp (the measured bound is stated in
``tests/test_torch_sampling.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY_F32 = 1.1754943508222875e-38       # float32's smallest normal number


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count pair ``(x1, x2)`` under the
    key ``(k1, k2)``: 20 rounds, a key injection every 4 (jax's
    ``_threefry2x32_lowering``).  Every argument is an int64 tensor of
    uint32 values; they broadcast together.

    Sums are masked once per key injection: the low 32 bits of a sum, a
    XOR or a left shift depend only on the low 32 bits of the operands,
    four unmasked rounds stay below 2^40, and only the rotation's right
    shift needs its operand masked (six tensor ops a round)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = x1 + ks[0]
    b = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            t = b & MASK32
            b = ((t << r) | (t >> (32 - r))) ^ a
        a = (a & MASK32) + ks[(i + 1) % 3]
        b = (b & MASK32) + ks[(i + 2) % 3] + (i + 1)
    return a & MASK32, b & MASK32


def prng_key(seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PRNGKey(seed)`` for uint32 seeds (int64 tensor): ``(0, seed)``
    (a 32-bit seed's high word is 0)."""
    seed = seed.to(torch.int64) & MASK32
    return torch.zeros_like(seed), seed


def fold_in(key: Tuple[torch.Tensor, torch.Tensor], data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(key, data)``: the hash of ``(0, data)`` under ``key``."""
    data = data.to(torch.int64) & MASK32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: Tuple[torch.Tensor, torch.Tensor], n: int
                ) -> torch.Tensor:
    """``random.bits(key, (n,), uint32)`` for a batch of keys ``[B]``:
    int64 ``[B, n]`` of uint32 words, element ``i`` the XOR of the hash
    of ``(0, i)``."""
    k1, k2 = key[0][:, None], key[1][:, None]
    i = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    a, b = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return a ^ b


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0
                      ) -> torch.Tensor:
    """jax's ``_uniform`` on 32 random bits with ``maxval`` 1: float32 in
    ``[minval, 1)``."""
    one = (bits >> 9) | 0x3F800000                  # 1.0's exponent
    f = one.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f + minval, min=minval)


def gumbel(key: Tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``random.gumbel(key, (n,), float32)`` (mode "low") for a batch of
    keys: float32 ``[B, n]``, each logarithm taken in float64 and rounded
    to float32."""
    u = uniform_from_bits(random_bits(key, n), TINY_F32)
    inner = (-torch.log(u.double())).float()
    return (-torch.log(inner.double())).float()


def positional_gumbel(seed: torch.Tensor, step: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """Slot ``b``'s noise for its emit offset ``step[b]``:
    ``gumbel(fold_in(PRNGKey(seed[b]), step[b]), (n,))``."""
    return gumbel(fold_in(prng_key(seed), step), n)
