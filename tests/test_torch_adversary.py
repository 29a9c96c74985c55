"""The count-controlling adversaries' closed forms and the unfused loop's
two branches that use them: benor_tpu_torch.ops.tally's
``adversarial_counts`` (with and without the equivocators' free pool),
``targeted_camp_triples`` and ``targeted_counts`` against the JAX
package's on random histograms (odd and even quorums, F = 0) — exactly
equal; the targeted counts realized as an explicit delivery schedule and
tallied back; and ``simulate(..., use_pallas_round=False)`` under
``scheduler='adversarial'`` and ``'targeted'`` (histogram and dense paths)
against the JAX package's unfused run, rounds, x, decided and k exactly
equal.  The closed forms run op by op on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import tally as jtally
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import scheduler as tsched
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs
from torch_ref_pool import prefetch, ref, start

J_ADV = jax.jit(jtally.adversarial_counts, static_argnums=1)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _hists(seed, t, n, free_max=0):
    """Random honest histograms of up to ``n`` senders (some summing to
    less than a quorum, some one class only) and free pools."""
    rs = np.random.default_rng(seed)
    hist = np.zeros((t, 3), np.int32)
    for i in range(t):
        total = int(rs.integers(0, n + 1))
        cuts = np.sort(rs.integers(0, total + 1, size=2))
        hist[i] = (cuts[0], cuts[1] - cuts[0], total - cuts[1])
    hist[0] = (n, 0, 0)
    hist[1] = (0, 0, n)
    free = rs.integers(0, free_max + 1, size=t).astype(np.int32)
    return hist, free


# (N, F): even and odd quorums, F = 0 (the adversary powerless), F > N / 2
SIZES = [(100, 20), (101, 20), (100, 0), (99, 60), (64, 31)]


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("free", [False, True], ids=["no-free", "free"])
def test_adversarial_counts_match_jax(n, f, free):
    hist, n_free = _hists(n + f, 16, n, free_max=f)
    m = n - f
    got = ttally.adversarial_counts(
        torch.from_numpy(hist), m,
        n_free=torch.from_numpy(n_free) if free else None)
    want = J_ADV(hist, m, n_free if free else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("fault_model", ["crash", "equivocate"])
def test_targeted_closed_forms_match_jax(n, f, fault_model):
    kw = dict(n_nodes=n, n_faulty=f, trials=16, delivery="quorum",
              scheduler="targeted", fault_model=fault_model)
    jc, tc = JCfg(**kw), bt.SimConfig(**kw)
    assert ttally.targeted_camp_sizes(tc) == jtally.targeted_camp_sizes(jc)
    hist, n_free = _hists(2 * n + f, 16, n, free_max=f)
    free = fault_model == "equivocate"
    nf_j = n_free if free else None
    nf_t = torch.from_numpy(n_free) if free else None
    trip = ttally.targeted_camp_triples(tc, torch.from_numpy(hist),
                                        n_free=nf_t)
    want = jtally.targeted_camp_triples(
        jc, jnp.asarray(hist), n_free=None if nf_j is None
        else jnp.asarray(nf_j))
    np.testing.assert_array_equal(trip.numpy(), np.asarray(want))
    ids = np.arange(n)
    got = ttally.targeted_counts(tc, torch.from_numpy(hist),
                                 torch.from_numpy(ids), n_free=nf_t)
    want = jtally.targeted_counts(
        jc, jnp.asarray(hist), jnp.asarray(ids), n_free=None if nf_j is None
        else jnp.asarray(nf_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the camp bounds the round kernels select by
    b0, b1 = ttally.targeted_camp_bounds(tc)
    idx = np.where(ids >= b1, 1, np.where(ids >= b0, 0, 2))
    np.testing.assert_array_equal(got.numpy(), trip.numpy()[:, idx, :])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_targeted_counts_realizable(seed):
    """dense_counts of the schedule realize_counts_mask builds from the
    targeted closed form gives the closed form back."""
    t, n, f = 8, 64, 20
    cfg = bt.SimConfig(n_nodes=n, n_faulty=f, trials=t, delivery="quorum",
                       scheduler="targeted", path="dense", seed=seed)
    rs = np.random.default_rng(seed)
    sent = torch.from_numpy(rs.integers(0, 3, (t, n)).astype(np.int8))
    alive = torch.from_numpy(rs.random((t, n)) < 0.9)
    alive[:, :cfg.quorum] = True          # the live senders cover a quorum
    hist = ttally.class_histogram(sent, alive)
    counts = ttally.targeted_counts(cfg, hist, torch.arange(n))
    mask = tsched.realize_counts_mask(counts, sent, alive)
    assert torch.equal(tdense.dense_counts(mask, sent, alive), counts)
    assert torch.equal(ttally.dense_counts(mask, sent, alive), counts)


def _kw(**kw):
    base = dict(n_nodes=96, trials=4, delivery="quorum",
                scheduler="adversarial", path="histogram", max_rounds=12,
                seed=3, use_pallas_round=False)
    base.update(kw)
    return base


def _faults(cfg, pkg):
    if cfg.fault_model in ("equivocate", "byzantine"):
        return pkg.first_f(cfg)
    return pkg.none(cfg.trials, cfg.n_nodes)


def _jax_unfused_run(kw):
    """The JAX package's run (a worker's call, see torch_ref_pool)."""
    jc = JCfg(**kw)
    vals = balanced_inputs(jc.trials, jc.n_nodes)
    jr, jst, _ = jsim.simulate(jc, vals, faults=_faults(jc, JFaults))
    return int(jr), {name: np.asarray(getattr(jst, name))
                     for name in ("x", "decided", "k", "killed")}


def _same_unfused_run(kw):
    tc = bt.SimConfig(**kw)
    vals = balanced_inputs(tc.trials, tc.n_nodes)
    jr, jfields = ref(_jax_unfused_run, kw)
    tr, tst, _ = bt.simulate(tc, vals, faults=_faults(tc, TFaults),
                             device="cpu")
    assert tr == jr
    for name in ("x", "decided", "k", "killed"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)
    return tr, tst


@pytest.mark.parametrize("kw", [
    dict(n_faulty=24, coin_mode="private"),
    dict(n_faulty=24, coin_mode="common"),
    dict(n_faulty=36, coin_mode="weak_common", coin_eps=0.3),
    dict(n_faulty=20, fault_model="byzantine", rule="textbook"),
    dict(n_faulty=31, fault_model="equivocate", coin_mode="common"),
    dict(n_faulty=33, fault_model="equivocate", coin_mode="common"),
    dict(scheduler="targeted", n_faulty=24),
    dict(scheduler="targeted", n_faulty=49),
    dict(scheduler="targeted", n_faulty=1, fault_model="equivocate"),
    dict(scheduler="targeted", n_faulty=24, path="dense"),
], ids=["adv-private", "adv-common", "adv-weak", "adv-byzantine",
        "adv-equiv-sub3f", "adv-equiv-super3f", "targeted",
        "targeted-half", "targeted-one-equivocator", "targeted-dense"])
@prefetch(lambda kw: [(_jax_unfused_run, _kw(**kw))])
def test_unfused_adversaries_match_jax(kw):
    """The unfused loop's adversarial and targeted branches (closed form on
    either path) equal the JAX package's unfused run."""
    rounds, final = _same_unfused_run(_kw(**kw))
    assert rounds >= 1
