"""32-bit word arithmetic of the device search, bit-exact against the
JAX package's uint32 code (``jepsen_tpu/checker/jax_wgl.py``).

PyTorch lacks uint32 ``>>``, ``-``, ``sum`` and ``min`` on the CPU, so
the port keeps two representations:

* **bitsets** (linearized-op sets, ok-op masks) are int32 tensors holding
  the uint32 bit pattern. Only ``&``, ``|``, ``==`` and masked shifts
  touch them, which mean the same on both types;
* **hash words** (fingerprints and their partial sums) are int64 tensors
  holding a value in [0, 2^32). Products are split into 16-bit halves so
  no int64 product overflows, and every sum is masked back to 32 bits.

A fingerprint that differed from the JAX package's would silently change
the search's dedup, so each function here is tested bit for bit against
its jnp counterpart (tests/test_torch_words.py).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def hash_keys(length, seed=0x9E3779B9):
    """Two vectors of random odd uint32 multipliers (multiply-shift
    universal hashing over config words), exactly as
    ``jax_wgl._hash_keys`` draws them."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    k = rng.randint(0, 2**31, size=(2, length)).astype(np.uint32)
    return (k[0] * 2 + 1), (k[1] * 2 + 1)


def u32(x):
    """An int32 bit pattern (or any integer tensor) as its uint32 value
    in an int64 tensor."""
    return x.to(torch.int64) & M32


def to_i32(x):
    """An int64 tensor's low 32 bits as an int32 bit pattern."""
    return (x & M32).to(torch.int32)


def mul32(h, c):
    """(h * c) mod 2^32 for h in [0, 2^32) and a constant c, without an
    int64 overflow: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def mix32(h):
    """The murmur3-style finalizer ``jax_wgl._mix32`` on uint32 values
    carried in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def popcount32(x):
    """Set bits of each uint32 value carried in int64 (SWAR); counts
    ``lax.population_count`` on the same words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def unpack_unlin(lin, n):
    """(..., B) int32 bitsets -> (..., n) bool, True where op i is NOT
    linearized: bit i % 32 of word i // 32 is clear
    (``jax_wgl.py:350-351``)."""
    bit = torch.arange(n, device=lin.device, dtype=torch.int32) % 32
    words = lin.repeat_interleave(32, dim=-1)[..., :n]
    return ((words >> bit) & 1) == 0


def bit_mask(i):
    """int32 bit pattern of ``1 << (i % 32)`` for int tensors ``i``."""
    return torch.bitwise_left_shift(
        torch.ones_like(i, dtype=torch.int32), (i % 32).to(torch.int32))


class Keys:
    """The per-position hash keys of one search (B bitset words, S state
    words and one salt word), on the search's device."""

    def __init__(self, B, S, device):
        k1, k2 = hash_keys(B + S + 1)          # +1: key salt
        self.B, self.S = B, S
        self.k1 = torch.as_tensor(k1.astype(np.int64), device=device)
        self.k2 = torch.as_tensor(k2.astype(np.int64), device=device)

    def finalize_fp(self, sum1, sum2, st, saltv):
        """Combine incremental lin-sums (leading shape L) with freshly
        hashed state words st (L, S) int32 and the per-key salt (L,)
        into the table fingerprint pair (``jax_wgl.py:291-305``)."""
        B, S = self.B, self.S
        stw = u32(st)
        s1 = (sum1 + mix32(stw ^ self.k1[B:B + S]).sum(-1)
              + mix32(saltv ^ self.k1[B + S])) & M32
        s2 = (sum2 + mix32(stw ^ self.k2[B:B + S]).sum(-1)
              + mix32(saltv ^ self.k2[B + S])) & M32
        h1 = mix32(s1)
        h2 = mix32(s2)
        # reserve (0,0): the empty table slot
        return h1, torch.where((h1 == 0) & (h2 == 0),
                               torch.ones_like(h2), h2)

    def lin_deltas(self, oldw, neww, wsel):
        """Sum deltas for flipping word index ``wsel`` (any shape) from
        oldw to neww (uint32 values in int64): mix(new^k_w) -
        mix(old^k_w), mod 2^32 (``jax_wgl.py:307-313``)."""
        kw1 = self.k1[wsel]
        kw2 = self.k2[wsel]
        return ((mix32(neww ^ kw1) - mix32(oldw ^ kw1)) & M32,
                (mix32(neww ^ kw2) - mix32(oldw ^ kw2)) & M32)

    def empty_lin_sums(self):
        """The lin-sums of the all-zero bitset (``jax_wgl.py:813-814``)."""
        B = self.B
        return (mix32(self.k1[:B]).sum() & M32,
                mix32(self.k2[:B]).sum() & M32)
