"""benor_tpu_torch/ops/rng.py (the fold_in chain) against the JAX package's
ops/rng.py on jax.random, bit for bit: keys, per-lane uniforms, the common
and private coins and the weak-common coin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu.ops import rng as jrng
from benor_tpu_torch.ops import rng as trng

T, N = 3, 50


def _key_words(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_fold_in_and_round_key_exact(seed):
    key = jax.random.key(seed)
    for data in (0, 1, 255, 2**31 - 1):
        assert trng.fold_in(trng.key_words(seed), data) == \
            _key_words(jax.random.fold_in(key, data))
    for r in (1, 2, 64):
        for phase in (trng.PHASE_PROPOSAL, trng.PHASE_VOTE, trng.PHASE_COIN,
                      trng.PHASE_COIN_DEV, 17):
            assert trng.round_key(seed, r, phase) == \
                _key_words(jrng.round_key(key, jnp.int32(r), phase))


@pytest.mark.parametrize("seed,r,phase", [(0, 1, 0), (5, 3, 1), (11, 64, 3)])
def test_grid_uniforms_exact(seed, r, phase):
    j = np.asarray(jrng.grid_uniforms(jax.random.key(seed), jnp.int32(r),
                                      phase, jrng.ids(T), jrng.ids(N)))
    t = trng.grid_uniforms(seed, r, phase, trng.ids(T), trng.ids(N)).numpy()
    assert t.dtype == np.float32 and t.shape == (T, N)
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


@pytest.mark.parametrize("common", [True, False])
def test_coin_flips_exact(common):
    for seed, r in ((1, 1), (9, 4)):
        j = np.asarray(jrng.coin_flips(jax.random.key(seed), jnp.int32(r),
                                       jrng.ids(T), jrng.ids(N), common))
        t = trng.coin_flips(seed, r, trng.ids(T), trng.ids(N), common)
        assert t.dtype == torch.int8 and tuple(t.shape) == (T, N)
        np.testing.assert_array_equal(t.numpy(), j)
    # the shared bit keyed on trial ids alone (the weak kernel's operand)
    j1 = np.asarray(jrng.coin_flips(jax.random.key(3), jnp.int32(2),
                                    jrng.ids(T), jrng.ids(1), True))[:, 0]
    t1 = trng.coin_flips(3, 2, trng.ids(T), trng.ids(1), True)[:, 0]
    np.testing.assert_array_equal(t1.numpy(), j1)


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_weak_common_coin_flips_exact(eps):
    j = np.asarray(jrng.weak_common_coin_flips(
        jax.random.key(4), jnp.int32(2), jrng.ids(T), jrng.ids(N), eps))
    t = trng.weak_common_coin_flips(4, 2, trng.ids(T), trng.ids(N), eps)
    np.testing.assert_array_equal(t.numpy(), j)


def test_ids_are_global():
    np.testing.assert_array_equal(trng.ids(5, offset=7).numpy(),
                                  np.asarray(jrng.ids(5, offset=7)))
