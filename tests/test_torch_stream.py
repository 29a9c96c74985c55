"""benor_tpu_torch/ops/stream.py against the JAX package's device math
(benor_tpu/ops/pallas_hist.py): threefry, stream keys and uniforms exact,
the normal quantile within 2e-6, CF draws exact at small populations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu.ops import pallas_hist as jh
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import stream as ts

def _u32(rng, size):
    return rng.integers(0, 1 << 32, size=size, dtype=np.uint64).astype(
        np.uint32)


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("k0,k1", [(0, 0), (0, 7), (0x12345678, 0x9ABCDEF0),
                                   (0xFFFFFFFF, 0xFFFFFFFF)])
def test_threefry_exact(k0, k1):
    rng = np.random.default_rng(k0 ^ k1)
    x0, x1 = _u32(rng, 1 << 16), _u32(rng, 1 << 16)
    j0, j1 = jh._threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                              jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = ts.threefry2x32(k0, k1, _t64(x0), _t64(x1))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    # the scalar (host) path agrees with the tensor path
    assert ts.threefry2x32(k0, k1, int(x0[0]), int(x1[0])) == \
        (int(t0[0]), int(t1[0]))


@pytest.mark.parametrize("seed", [0, 5, 2**31, 2**32 - 1, 2**32, 2**33 + 5,
                                  -1])
def test_stream_keys_exact(seed):
    kd = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert trng.key_words(seed) == tuple(int(v) for v in kd.reshape(-1))
    key = jax.random.key(seed)
    for r in (0, 1, 7, 64):
        for salt in (trng.PHASE_PROPOSAL, trng.PHASE_VOTE, ts._COIN_SALT,
                     trng.PHASE_VOTE + ts._EQUIV_SALT_OFFSET):
            j = np.asarray(jh._stream_scal(key, jnp.int32(r), salt, 0, 0))
            assert ts.stream_scal(seed, r, salt) + (0, 0) == \
                tuple(int(v) for v in j)


def test_lane_ids_are_global_counters():
    t, n = 3, 1000
    node, trial = ts.lane_ids(t, n, "cpu")
    assert tuple((node + 0 * trial).shape) == (t, n)
    np.testing.assert_array_equal(node[0].numpy(), np.arange(n))
    np.testing.assert_array_equal(trial[:, 0].numpy(), np.arange(t))


def test_bits_to_uniform_exact():
    bits = _u32(np.random.default_rng(3), (4, 1 << 14))
    bits[0, :6] = [0, 1, 511, 512, 0xFFFFFFFF, 0xFFFFFE00]
    j = np.asarray(jax.jit(jh._bits_to_uniform)(jnp.asarray(bits)))
    t = ts.bits_to_uniform(_t64(bits)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def _uniforms(seed, n):
    bits = _u32(np.random.default_rng(seed), n)
    return ts.bits_to_uniform(_t64(bits))


def test_ndtri_within_2e6():
    u = _uniforms(11, 1 << 18)
    u[:4] = torch.tensor([1e-7, 1 - 1e-7, 0.5, 0.075])
    j = np.asarray(jh._ndtri_as241(jnp.asarray(u.numpy())))
    t = ts.ndtri_clipped(u).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)


@pytest.mark.parametrize("total,good,nsample", [
    (96, 40, 72), (96, 0, 72), (96, 96, 72), (1000, 500, 550),
    (1000, 123, 999), (4096, 2048, 3000), (4096, 1, 4096), (1, 1, 1),
])
def test_cf_draw_exact_small_populations(total, good, nsample):
    u = _uniforms(total + good, 1 << 16)
    j = np.asarray(jh._cf_draw(jnp.asarray(u.numpy()), jnp.float32(total),
                               jnp.float32(good), jnp.float32(nsample)))
    t = ts.cf_draw(u, torch.tensor(float(total)), torch.tensor(float(good)),
                   float(nsample)).numpy()
    np.testing.assert_array_equal(t, j)


def test_cf_draw_large_population_rarely_off_by_one():
    """At a population of 1e6 the last-ulp differences of the normal
    quantile can move a draw by one count; allow +-1 on at most 1e-4 of
    2**18 draws (the measured rate is about 8e-6)."""
    n = 1 << 18
    u = _uniforms(99, n)
    rng = np.random.default_rng(7)
    total = np.float32(1e6)
    good = rng.integers(0, 1_000_000, size=n).astype(np.float32)
    m = np.float32(550_000)
    j = np.asarray(jh._cf_draw(jnp.asarray(u.numpy()), jnp.float32(total),
                               jnp.asarray(good), jnp.float32(m)))
    t = ts.cf_draw(u, torch.tensor(float(total)), torch.from_numpy(good),
                   float(m)).numpy()
    d = np.abs(t - j)
    assert d.max() <= 1.0
    assert (d > 0).sum() <= 1e-4 * n
