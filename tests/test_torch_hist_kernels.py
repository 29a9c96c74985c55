"""The port's four histogram-round kernels (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode (benor_tpu/ops/pallas_hist.py): the same histogram, counts
and key -> exactly equal int32 counts and int8 coins.  N = 1000 leaves pad
lanes in the TPU's last tile, N = 1024 fills two tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu.ops import pallas_hist as jh
from benor_tpu.ops import rng as jrng
from benor_tpu_torch.ops import hist as th
from benor_tpu_torch.ops import rng as trng
from torch_ref_pool import prefetch, ref, start

# (trials, nodes, seed, round, phase)
CASES = [
    (2, 1000, 3, 1, trng.PHASE_PROPOSAL),
    (3, 1024, 8, 5, trng.PHASE_VOTE),
    (3, 1000, 21, 2, trng.PHASE_VOTE),
]


@pytest.fixture(scope="module", autouse=True)
def _reference_ahead(request):
    """Start the JAX sides ahead (torch_ref_pool)."""
    start(request)


def _hist(t, n, seed):
    """A per-trial class histogram of n live senders, "?" included."""
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, n, size=t)
    c1 = rng.integers(0, n - c0 + 1)
    return np.stack([c0, c1, n - c0 - c1], axis=1).astype(np.int32)


def _jax_cf_counts(t, n, seed, r, phase):
    """The JAX package's kernels in interpret mode (``_jax_*``: a worker's
    calls, see torch_ref_pool)."""
    return np.asarray(jh.cf_counts_pallas(
        jax.random.key(seed), jnp.int32(r), phase,
        jnp.asarray(_hist(t, n, seed)), n - n // 3, n, interpret=True))


@pytest.mark.parametrize("t,n,seed,r,phase", CASES)
@prefetch(lambda t, n, seed, r, phase: [(_jax_cf_counts, t, n, seed, r,
                                         phase)])
def test_cf_counts_matches_pallas(t, n, seed, r, phase):
    hist = _hist(t, n, seed)
    m = n - n // 3
    j = ref(_jax_cf_counts, t, n, seed, r, phase)
    out = th.cf_counts(seed, r, phase, torch.from_numpy(hist), m, n)
    assert out.dtype == torch.int32 and tuple(out.shape) == (t, n, 3)
    np.testing.assert_array_equal(out.numpy(), j)
    assert (out.sum(-1) == m).all()


def _equiv_inputs(t, n, seed):
    hist = _hist(t, n - n // 5, seed)          # the honest live senders
    n_equiv = np.full((t,), n // 5, np.int32)
    n_equiv[0] -= 1                            # one equivocator not live
    return hist, n_equiv, n - n // 5


def _jax_equiv_counts(t, n, seed, r, phase):
    hist, n_equiv, m = _equiv_inputs(t, n, seed)
    return np.asarray(jh.equiv_counts_pallas(
        jax.random.key(seed), jnp.int32(r), phase, jnp.asarray(hist),
        jnp.asarray(n_equiv), m, n, interpret=True))


@pytest.mark.parametrize("t,n,seed,r,phase", CASES)
@prefetch(lambda t, n, seed, r, phase: [(_jax_equiv_counts, t, n, seed, r,
                                         phase)])
def test_equiv_counts_matches_pallas(t, n, seed, r, phase):
    hist, n_equiv, m = _equiv_inputs(t, n, seed)
    j = ref(_jax_equiv_counts, t, n, seed, r, phase)
    out = th.equiv_counts(seed, r, phase, torch.from_numpy(hist),
                          torch.from_numpy(n_equiv), m, n)
    assert out.dtype == torch.int32 and tuple(out.shape) == (t, n, 3)
    np.testing.assert_array_equal(out.numpy(), j)


def _jax_coin_flips(t, n, seed, r):
    return np.asarray(jh.coin_flips_pallas(jax.random.key(seed),
                                           jnp.int32(r), t, n,
                                           interpret=True))


@pytest.mark.parametrize("t,n,seed,r,phase", CASES)
@prefetch(lambda t, n, seed, r, phase: [(_jax_coin_flips, t, n, seed, r)])
def test_coin_flips_matches_pallas(t, n, seed, r, phase):
    j = ref(_jax_coin_flips, t, n, seed, r)
    out = th.coin_flips(seed, r, t, n, "cpu")
    assert out.dtype == torch.int8 and tuple(out.shape) == (t, n)
    np.testing.assert_array_equal(out.numpy(), j)


def _jax_weak_coin_flips(t, n, seed, r):
    """The shared bits, then the weak coin at eps 0.3 and 0.5."""
    key = jax.random.key(seed)
    jshared = jrng.coin_flips(key, jnp.int32(r), jrng.ids(t), jrng.ids(1),
                              common=True)[:, 0]
    return np.asarray(jshared), [
        np.asarray(jh.weak_coin_flips_pallas(key, jnp.int32(r), t, n, eps,
                                             jshared, interpret=True))
        for eps in (0.3, 0.5)]


@pytest.mark.parametrize("t,n,seed,r,phase", CASES)
@prefetch(lambda t, n, seed, r, phase: [(_jax_weak_coin_flips, t, n, seed,
                                         r)])
def test_weak_coin_flips_matches_pallas(t, n, seed, r, phase):
    jshared, js = ref(_jax_weak_coin_flips, t, n, seed, r)
    shared = trng.coin_flips(seed, r, trng.ids(t), trng.ids(1),
                             common=True)[:, 0]
    np.testing.assert_array_equal(shared.numpy(), jshared)
    for eps, j in zip((0.3, 0.5), js):
        out = th.weak_coin_flips(seed, r, t, n, eps, shared)
        assert out.dtype == torch.int8 and tuple(out.shape) == (t, n)
        np.testing.assert_array_equal(out.numpy(), j)


def test_weak_coin_eps_limits():
    """eps = 1 is the private coin, eps = 0 the shared bit."""
    t, n, seed, r = 3, 1000, 6, 4
    shared = trng.coin_flips(seed, r, trng.ids(t), trng.ids(1),
                             common=True)[:, 0]
    assert torch.equal(th.weak_coin_flips(seed, r, t, n, 1.0, shared),
                       th.coin_flips(seed, r, t, n, "cpu"))
    assert torch.equal(th.weak_coin_flips(seed, r, t, n, 0.0, shared),
                       shared[:, None].expand(t, n))


def test_cpu_wrappers_never_count_launches():
    th.reset_launches()
    hist = torch.from_numpy(_hist(2, 1000, 1))
    th.cf_counts(1, 1, 0, hist, 700, 1000)
    th.equiv_counts(1, 1, 0, hist, torch.tensor([10, 10]), 700, 1000)
    th.coin_flips(1, 1, 2, 1000, "cpu")
    th.weak_coin_flips(1, 1, 2, 1000, 0.5, torch.tensor([0, 1]))
    assert {k: f.launches for k, f in th.KERNELS.items()} == \
        dict.fromkeys(th.KERNELS, 0)


def test_wrappers_refuse_other_devices():
    hist = torch.from_numpy(_hist(2, 1000, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        th.cf_counts(1, 1, 0, hist.to("meta"), 700, 1000)
    with pytest.raises(ValueError, match="cuda or cpu"):
        th.coin_flips(1, 1, 2, 1000, "meta")
