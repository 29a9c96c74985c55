"""``delivery='all'`` (the broadcast histogram) against the JAX package:
the ``'all'`` branch of benor_tpu_torch.ops.tally.receiver_counts, the
equivocator split's samplers (ops/sampling.py), and
benor_tpu_torch.simulate(..., device="cpu") against benor_tpu.sim.simulate
— rounds, x, decided, k and killed exactly equal per trial — for the
reference's default SimConfig, each fault model, coin and rule.  The JAX
side runs under ``jax.jit`` on numpy inputs, to keep the test process's
XLA compile count low."""

import contextlib

import numpy as np
import pytest
import torch

import jax

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu.ops import tally as jtally
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import hist as thist
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs
from torch_ref_pool import prefetch, ref, start

FIELDS = ("x", "decided", "k", "killed")
J_RECEIVER_COUNTS = jax.jit(jtally.receiver_counts, static_argnums=0)
J_HALF = jax.jit(jsampling.binomial_half)
J_HALF_EXACT = jax.jit(jsampling.binomial_half_exact_shared,
                       static_argnums=2)
J_NDTRI = jax.jit(jax.scipy.special.ndtri)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


@contextlib.contextmanager
def _table_max(value):
    """EXACT_TABLE_MAX set to ``value`` in BOTH packages (unchanged for
    None), restored on exit."""
    old = jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX
    if value is not None:
        jsampling.EXACT_TABLE_MAX = tsampling.EXACT_TABLE_MAX = value
    try:
        yield
    finally:
        jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX = old


# --- the equivocator split's samplers ---------------------------------------


def test_binomial_half_matches_jax():
    """The normal-quantile split equals JAX's draw for draw at the test
    sizes, from n = 0 to a million."""
    rs = np.random.default_rng(5)
    u = rs.random((8, 4096), dtype=np.float32)
    n = np.array([[0], [1], [2], [7], [37], [250], [4096], [200_000]],
                 np.int32)
    want = np.asarray(J_HALF(u, n))
    got = tsampling.binomial_half(torch.from_numpy(u), torch.from_numpy(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ndtri_matches_jax_to_an_ulp():
    """The Cephes quantile, op for op: equal to JAX's on most uniforms and
    within 8 f32 ulps on every one (XLA:CPU's ``log`` and ``sqrt`` round
    differently from torch's; this seed: 18.7 % differ, by at most 6
    ulps), over the clipped range the split draws from and its end
    points.  ``pytest -s`` prints the measured fraction."""
    rs = np.random.default_rng(6)
    p = np.concatenate([rs.random(1_000_000, dtype=np.float32),
                        np.float32([1e-7, 1 - 1e-7, 0.5, np.exp(-2.0),
                                    1 - np.exp(-2.0), 0.0, 1.0])])
    p = np.clip(p, 0.0, 1.0).astype(np.float32)
    want = np.asarray(J_NDTRI(p))
    got = tsampling.ndtri(torch.from_numpy(p)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                  - want[fin].view(np.int32).astype(np.int64))
    print(f"ndtri vs JAX: {int((ulps > 0).sum())} of {ulps.size} differ, "
          f"at most {int(ulps.max())} ulps")
    np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=8)
    assert (got != want).mean() < 0.25


@pytest.mark.parametrize("n_max", [2, 4, 8])
def test_binomial_half_exact_shared_matches_jax(n_max):
    """The exact shared table equals JAX's draw for draw at n <= 8, every
    n from 0 to n_max, at the test sizes."""
    rs = np.random.default_rng(n_max)
    u = rs.random((n_max + 1, 1024), dtype=np.float32)
    n = np.arange(n_max + 1, dtype=np.int32)
    want = np.asarray(J_HALF_EXACT(u, n, n_max))
    got = tsampling.binomial_half_exact_shared(
        torch.from_numpy(u), torch.from_numpy(n), n_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_equiv,bound", [(37, 9), (250, 113),
                                           (4096, 9814)])
def test_binomial_half_exact_shared_differing_fraction(n_equiv, bound):
    """Large equivocator counts: ``torch.lgamma`` and XLA's ``gammaln``
    round differently, so the table moves a few draws.  Over 1M uniforms
    with the 4096-entry table the differing draws stay at most 9, 113 and
    9814 — the counts measured over 2M uniforms before the port, i.e.
    twice that fraction (this seed: 5, 48 and 4908; ``pytest -s`` prints
    them)."""
    u = np.random.default_rng(0).random((1, 1_000_000), dtype=np.float32)
    n = np.array([n_equiv], np.int32)
    want = np.asarray(J_HALF_EXACT(u, n, 4096))
    got = tsampling.binomial_half_exact_shared(
        torch.from_numpy(u), torch.from_numpy(n), 4096).numpy()
    assert 0 <= got.min() and got.max() <= n_equiv
    n_diff = int((got != want).sum())
    print(f"exact table vs JAX at n_equiv={n_equiv}: {n_diff} of "
          f"{got.size} draws differ")
    assert n_diff <= bound
    assert abs(float(got.mean()) - n_equiv / 2) < 0.01 * n_equiv + 0.1


# --- receiver_counts, one tally ----------------------------------------------


def _rc_inputs(kw):
    t, n = 3, 48
    base = dict(n_nodes=n, n_faulty=12, trials=t, delivery="all", seed=6)
    base.update(kw)
    rs = np.random.default_rng(17)
    sent = rs.integers(0, 3, (t, n)).astype(np.int8)
    alive = rs.random((t, n)) < 0.8
    equiv = (rs.random((t, n)) < 0.3) \
        if base.get("fault_model") == "equivocate" else None
    return base, sent, alive, equiv


def _jax_receiver_counts(base, sent, alive, equiv):
    """The JAX tally at (r, phase) = (1, 0) and (3, 1) with
    EXACT_TABLE_MAX = 16, under ``jax.jit`` (a worker's call, see
    torch_ref_pool)."""
    jc = JCfg(**base)
    with _table_max(16):
        return [np.asarray(J_RECEIVER_COUNTS(
            jc, jax.random.key(jc.seed), r, phase, sent, alive,
            equiv=equiv)) for r, phase in ((1, 0), (3, 1))]


@pytest.mark.parametrize("kw", [
    dict(fault_model="crash"),
    dict(fault_model="byzantine"),
    dict(fault_model="crash", path="histogram"),
    dict(fault_model="equivocate", n_faulty=12),
    dict(fault_model="equivocate", n_faulty=20, seed=7),
], ids=["crash", "byzantine", "crash-histogram", "equivocate-table",
        "equivocate-quantile"])
@prefetch(lambda kw: [(_jax_receiver_counts, *_rc_inputs(kw))])
def test_all_receiver_counts_match_jax(kw):
    """Every receiver tallies the honest live histogram (plus the
    equivocator split): exact against JAX with dead lanes.  The split
    takes the exact table at F = 12 and the normal quantile at F = 20,
    above a lowered EXACT_TABLE_MAX."""
    base, sent, alive, equiv = _rc_inputs(kw)
    tc = bt.SimConfig(**base)
    t, n = tc.trials, tc.n_nodes
    wants = ref(_jax_receiver_counts, base, sent, alive, equiv)
    with _table_max(16):
        for (r, phase), want in zip(((1, 0), (3, 1)), wants):
            got = ttally.receiver_counts(
                tc, tc.seed, r, phase, torch.from_numpy(sent),
                torch.from_numpy(alive),
                None if equiv is None else torch.from_numpy(equiv))
            assert got.dtype == torch.int32 and tuple(got.shape) == (t, n, 3)
            np.testing.assert_array_equal(got.numpy(), want)
    if equiv is None:
        # the broadcast histogram is a view of [T, 3]: no [T, N, 3] memory
        assert got.stride(1) == 0


# --- simulate -----------------------------------------------------------------


def _jax_run(kw, vals, faulty_list, table_max, as_list=False):
    """The JAX package's run with EXACT_TABLE_MAX = ``table_max`` (unchanged
    for None); the faulty list passed as ``simulate``'s third argument
    where ``as_list`` (a worker's call, see torch_ref_pool)."""
    jc = JCfg(**kw)
    t, n = jc.trials, jc.n_nodes
    if as_list:
        jf = faulty_list
    elif faulty_list is None:
        jf = JFaults.none(t, n)
    else:
        jf = JFaults.from_faulty_list(jc, faulty_list)
    with _table_max(table_max):
        jr, jst, _ = (jsim.simulate(jc, vals, jf) if as_list
                      else jsim.simulate(jc, vals, faults=jf))
    return int(jr), {name: np.asarray(getattr(jst, name)) for name in FIELDS}


def _assert_same_run(kw, vals, faulty_list=None, table_max=None,
                     min_rounds=1):
    tc = bt.SimConfig(**kw)
    assert not ttally.pallas_round_active(tc)
    t, n = tc.trials, tc.n_nodes
    if faulty_list is None:
        tf = TFaults.none(t, n)
    else:
        tf = TFaults.from_faulty_list(tc, faulty_list)
    jr, jfields = ref(_jax_run, kw, vals, faulty_list, table_max)
    with _table_max(table_max):
        tr, tst, _ = bt.simulate(tc, vals, faults=tf, device="cpu")
    assert tr == jr
    assert tr >= min_rounds
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)


_DEFAULT = (dict(n_nodes=10, n_faulty=4, max_rounds=20),
            [0, 0, 1, 1, 1, 0, 0, 1, 1, 1], [True] * 4 + [False] * 6)


@prefetch(lambda: [(_jax_run, *_DEFAULT, None, True)])
def test_default_config_matches_jax():
    """The JAX package's default SimConfig — N = 10, F = 4, delivery='all',
    path='auto' — on the upstream repo's inputs, through the public
    ``simulate`` with a faulty list, as its README calls it."""
    cfg, vals, faulty = _DEFAULT
    jr, jfields = ref(_jax_run, cfg, vals, faulty, None, True)
    tr, tst, _ = bt.simulate(bt.SimConfig(**cfg), vals, faulty,
                             device="cpu")
    assert bt.SimConfig(**cfg).delivery == "all"
    assert tr == jr >= 1
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)
    assert bool(tst.decided[0, 4:].all())


_B = dict(n_nodes=96, n_faulty=40, trials=4, max_rounds=24, delivery="all")
_FIRST40 = [True] * 40 + [False] * 56


@pytest.mark.parametrize("kw,faulty,table_max", [
    (dict(seed=1), _FIRST40, None),
    (dict(seed=2, fault_model="byzantine", rule="textbook"), _FIRST40, None),
    (dict(seed=3, fault_model="equivocate", coin_mode="common"), _FIRST40,
     None),
    (dict(seed=4, fault_model="equivocate", coin_mode="weak_common",
          coin_eps=0.5, freeze_decided=False), _FIRST40, 8),
    (dict(seed=5, n_faulty=24, path="histogram", use_pallas_hist=True,
          use_pallas_round=True), None, None),
    (dict(seed=6, n_faulty=24, coin_mode="weak_common", coin_eps=0.5,
          rule="textbook", freeze_decided=False), None, None),
], ids=["crash", "byzantine-textbook", "equivocate-table-common",
        "equivocate-quantile-weak-nofreeze", "histogram-round-flags",
        "weak-textbook-nofreeze"])
@prefetch(lambda kw, faulty, table_max: [
    (_jax_run, {**_B, **kw}, balanced_inputs(4, 96), faulty, table_max)])
def test_all_simulate_matches_jax(kw, faulty, table_max):
    """Balanced inputs tie every round-1 tally under broadcast delivery,
    so every lane takes the coin before it can decide: each coin and rule
    is reached.  The equivocator split takes the exact table at F = 40
    and the normal quantile above a lowered EXACT_TABLE_MAX;
    ``use_pallas_round=True`` still runs the unfused loop, as in JAX."""
    cfg = {**_B, **kw}
    _assert_same_run(cfg, balanced_inputs(4, 96), faulty, table_max,
                     min_rounds=2 if kw.get("fault_model") != "equivocate"
                     else 1)


def test_all_slices_equal_one_shot():
    """run_consensus_slice in one-round slices equals the one-shot run."""
    cfg = bt.SimConfig(**{**_B, "seed": 9, "fault_model": "equivocate"})
    vals, faults = balanced_inputs(4, 96), TFaults.first_f(cfg)
    r_one, one = bt.run_consensus(cfg, bt.init_state(cfg, vals, faults),
                                  faults)
    state = bt.sim.start_state(cfg, bt.init_state(cfg, vals, faults))
    r = 1
    while True:
        r_next, state = bt.run_consensus_slice(cfg, state, faults, r, r + 1)
        if r_next == r:
            break
        r = r_next
    assert r - 1 == r_one
    for name in FIELDS:
        assert torch.equal(getattr(state, name), getattr(one, name)), name


def test_all_cpu_run_launches_no_kernel():
    """The broadcast path is plain torch: no kernel wrapper is reached,
    whatever the kernel switches say."""
    for ops in (thist, tround, tdense):
        ops.reset_launches()
    cfg = bt.SimConfig(**{**_B, "seed": 10, "use_pallas": True,
                          "use_pallas_hist": True,
                          "use_pallas_round": True, "path": "histogram",
                          "coin_mode": "weak_common", "coin_eps": 0.5})
    bt.simulate(cfg, balanced_inputs(4, 96), faults=TFaults.none(4, 96),
                device="cpu")
    for table in (thist.KERNELS, tround.KERNELS, tdense.KERNELS):
        assert all(fn.launches == 0 for fn in table.values())


@pytest.mark.parametrize("kw,item", [
    (dict(drop_prob=0.2, path="histogram"), None),
    (dict(committee_cap=4, committee_count=2, committee_size=8), None),
], ids=["omission-histogram", "committees"])
def test_all_neighbours_still_raise(kw, item):
    """The neighbours of the broadcast path that once raised here run now
    (``item`` None), with no kernel launched: omission on the histogram
    path by binomial thinning (tests/test_torch_hist_regimes.py holds it
    against JAX) and committees (tests/test_torch_topo.py), whose ~8
    members can never muster count > F = 40: no lane decides, the run
    takes every round."""
    assert item is None
    cfg = bt.SimConfig(**{**_B, **kw})
    args = (cfg, balanced_inputs(4, 96))
    kw = dict(faults=TFaults.none(4, 96), device="cpu")
    for ops in (thist, tround, tdense):
        ops.reset_launches()
    rounds, st, _ = bt.simulate(*args, **kw)
    assert 1 <= rounds <= cfg.max_rounds
    if cfg.committee_cap:
        assert rounds == cfg.max_rounds and not bool(st.decided.any())
        assert bool((st.k >= 1).all() & (st.k <= rounds + 1).all())
    else:
        assert bool(st.decided.all())
    for table in (thist.KERNELS, tround.KERNELS, tdense.KERNELS):
        assert all(fn.launches == 0 for fn in table.values())


def test_all_partition_raises_at_config():
    """A malformed partition spec raises the JAX package's ValueError, word
    for word, where the JAX package parses it; a valid spec runs, stalling
    every lane until the heal (k above the heal round)."""
    bad = {**_B, "partition": "0-47|48-95@1-3"}
    with pytest.raises(ValueError) as want:
        JCfg(**bad)
    with pytest.raises(ValueError) as got:
        bt.SimConfig(**bad)
    assert str(got.value) == str(want.value)
    cfg = bt.SimConfig(**{**_B, "partition": "halves:3"})
    rounds, st, _ = bt.simulate(cfg, balanced_inputs(4, 96),
                                faulty_list=_FIRST40, device="cpu")
    assert rounds >= 3
    assert bool(st.decided[~st.killed].all())
    assert bool((st.k[st.decided] > 3).all())
