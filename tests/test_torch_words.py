"""The port's 32-bit word arithmetic (jepsen_tpu_torch/checker/words.py)
is bit-exact against the JAX package's uint32 code in checker/jax_wgl.py,
on random words with the high bits set. Tolerance: equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from jepsen_tpu.checker import jax_wgl
from jepsen_tpu_torch.checker import words


def _words(rng, shape):
    """Random uint32 words, a quarter of them with bit 31 forced on."""
    w = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[rng.rand(*shape) < 0.25] |= np.uint32(1 << 31)
    return w


def _t64(w):
    return torch.from_numpy(w.astype(np.int64))


def test_hash_keys_match():
    for length in (3, 40, 257):
        a1, a2 = jax_wgl._hash_keys(length)
        b1, b2 = words.hash_keys(length)
        assert np.array_equal(a1, b1) and np.array_equal(a2, b2)


def test_mix32_bit_exact():
    w = _words(np.random.RandomState(1), (4096,))
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jax_wgl._mix32(jnp.asarray(w)))
    got = words.mix32(_t64(w)).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


def test_popcount_bit_exact():
    w = _words(np.random.RandomState(2), (2048,))
    want = np.asarray(lax.population_count(jnp.asarray(w)))
    assert np.array_equal(words.popcount32(_t64(w)).numpy(), want)


@pytest.mark.parametrize("n", [32, 100, 256])
def test_unpack_bit_exact(n):
    B = (n + 31) // 32
    lin = _words(np.random.RandomState(n), (3, 5, B))
    bit_idx = (np.arange(n) % 32).astype(np.uint32)
    wbits = jnp.repeat(jnp.asarray(lin), 32, axis=2)[:, :, :n]
    want = np.asarray(((wbits >> bit_idx) & jnp.uint32(1)) == 0)
    got = words.unpack_unlin(torch.from_numpy(lin.view(np.int32)), n)
    assert np.array_equal(got.numpy(), want)


def test_bit_mask_and_word_views():
    i = torch.arange(96)
    want = (np.uint32(1) << (np.arange(96) % 32).astype(np.uint32))
    assert np.array_equal(words.u32(words.bit_mask(i)).numpy(),
                          want.astype(np.int64))
    x = torch.tensor([0, 2**31, 2**32 - 1, 5], dtype=torch.int64)
    assert words.to_i32(x).tolist() == [0, -2**31, -1, 5]


def _jnp_fp(B, S):
    """jax_wgl's finalize_fp / lin_deltas closures (jax_wgl.py:291-313),
    over the same keys."""
    k1, k2 = jax_wgl._hash_keys(B + S + 1)
    k1j, k2j = jnp.asarray(k1), jnp.asarray(k2)
    mix = jax_wgl._mix32

    def finalize_fp(sum1, sum2, st, saltv):
        stw = st.astype(jnp.uint32)
        s1 = sum1 + jnp.sum(mix(stw ^ k1j[B:B + S]), axis=-1,
                            dtype=jnp.uint32) + mix(saltv ^ k1j[B + S])
        s2 = sum2 + jnp.sum(mix(stw ^ k2j[B:B + S]), axis=-1,
                            dtype=jnp.uint32) + mix(saltv ^ k2j[B + S])
        h1, h2 = mix(s1), mix(s2)
        return h1, jnp.where((h1 == 0) & (h2 == 0), jnp.uint32(1), h2)

    def lin_deltas(oldw, neww, wsel):
        kw1, kw2 = jnp.take(k1j, wsel), jnp.take(k2j, wsel)
        return (mix(neww ^ kw1) - mix(oldw ^ kw1),
                mix(neww ^ kw2) - mix(oldw ^ kw2))

    def empty_sums():
        return (jnp.sum(mix(k1j[:B]), dtype=jnp.uint32),
                jnp.sum(mix(k2j[:B]), dtype=jnp.uint32))

    return finalize_fp, lin_deltas, empty_sums


@pytest.mark.parametrize("B,S", [(8, 1), (256, 1), (3, 4)])
def test_finalize_fp_and_lin_deltas_bit_exact(B, S):
    rng = np.random.RandomState(B * 7 + S)
    finalize_fp, lin_deltas, empty_sums = _jnp_fp(B, S)
    keys = words.Keys(B, S, torch.device("cpu"))
    L = 1000
    s1, s2, salt = (_words(rng, (L,)) for _ in range(3))
    st = _words(rng, (L, S)).view(np.int32)
    want = finalize_fp(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(st),
                       jnp.asarray(salt))
    got = keys.finalize_fp(_t64(s1), _t64(s2), torch.from_numpy(st),
                           _t64(salt))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    oldw = _words(rng, (L,))
    neww = oldw | _words(rng, (L,))
    wsel = rng.randint(0, B, size=L)
    want = lin_deltas(jnp.asarray(oldw), jnp.asarray(neww),
                      jnp.asarray(wsel))
    got = keys.lin_deltas(_t64(oldw), _t64(neww), torch.from_numpy(wsel))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    for g, w in zip(keys.empty_lin_sums(), empty_sums()):
        assert int(g) == int(w)
