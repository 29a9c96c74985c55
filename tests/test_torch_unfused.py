"""End to end on the unfused histogram round (use_pallas_round=False):
benor_tpu_torch.simulate(..., device="cpu") against benor_tpu.sim.simulate
— rounds, x, decided, k and killed exactly equal per trial — for each fault
model, coin and rule of the slice; the unfused loop against the port's own
packed loop; runs in slices and resumed runs against the one-shot run on
both loops; and the no-kernel, no-fallback rules."""

import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.faults import crash_recover_faults
from benor_tpu_torch.models import benor as tbenor
from benor_tpu_torch.ops import hist as thist
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs
from torch_ref_pool import prefetch, ref, start

N, T = 96, 4
FIELDS = ("x", "decided", "k", "killed")


@pytest.fixture(scope="module", autouse=True)
def _reference_ahead(request):
    """Start the JAX sides ahead (torch_ref_pool)."""
    start(request)


@pytest.fixture
def cf_regime():
    """Force the CF regime at small N in BOTH packages (quorum > 4)."""
    old = jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = tsampling.EXACT_TABLE_MAX = 4
    try:
        yield
    finally:
        jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX = old


def _kw(use_round=False, **kw):
    kw.setdefault("max_rounds", 24)
    return dict(n_nodes=N, trials=T, delivery="quorum", scheduler="uniform",
                path="histogram", use_pallas_hist=True,
                use_pallas_round=use_round, **kw)


def _faults(cfg, pkg):
    """Crash faults at birth; the first F lanes faulty for byzantine and
    equivocate (alive, so the quorum sees them); none at F = 40, the
    multi-round regime."""
    if cfg.n_faulty == 40:
        return pkg.none(T, N)
    return pkg.first_f(cfg)


def _jax_run(kw, faults):
    """The JAX package's run in the CF regime (EXACT_TABLE_MAX = 4, as
    ``cf_regime``); ``faults`` "none" or "first_f" (a worker's call, see
    torch_ref_pool)."""
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = 4
    try:
        jc = JCfg(**kw)
        jf = JFaults.none(T, N) if faults == "none" else JFaults.first_f(jc)
        jr, jst, _ = jsim.simulate(jc, balanced_inputs(T, N), faults=jf)
        return int(jr), {name: np.asarray(getattr(jst, name))
                         for name in FIELDS}
    finally:
        jsampling.EXACT_TABLE_MAX = old


def _match_call(kw):
    return (_jax_run, _kw(**kw),
            "none" if kw["n_faulty"] == 40 else "first_f")


def _coin_committed(cfg, faults):
    """True iff some lane commits a coin in some round of the port's run:
    rerun each round from the same state with every coin flipped and look
    for a different new x (only a lane that took the coin branch moves)."""
    state = tsim.start_state(cfg, bt.init_state(cfg, balanced_inputs(T, N),
                                                faults))
    real_coin = tbenor._coin
    for r in range(1, cfg.max_rounds + 1):
        if bool(tbenor.all_settled(state)):
            return False
        nxt = tbenor.benor_round(cfg, state, faults, cfg.seed, r)
        tbenor._coin = lambda *a: 1 - real_coin(*a)
        try:
            flipped = tbenor.benor_round(cfg, state, faults, cfg.seed, r)
        finally:
            tbenor._coin = real_coin
        if not torch.equal(nxt.x, flipped.x):
            return True
        state = nxt
    return False


@pytest.mark.parametrize("kw,min_rounds,coins", [
    (dict(n_faulty=24, seed=3), 1, False),
    (dict(n_faulty=20, seed=15, fault_model="byzantine"), 1, False),
    (dict(n_faulty=30, seed=5, rule="textbook"), 1, False),
    (dict(n_faulty=24, seed=11, freeze_decided=False), 1, False),
    (dict(n_faulty=20, seed=19, fault_model="equivocate"), 1, False),
    (dict(n_faulty=40, seed=7, coin_mode="common"), 2, True),
    (dict(n_faulty=40, seed=9, coin_mode="weak_common", coin_eps=0.5), 2,
     True),
    (dict(n_faulty=40, seed=1), 2, True),
    (dict(n_faulty=40, seed=10, fault_model="byzantine", rule="textbook",
          freeze_decided=False), 2, True),
    (dict(n_faulty=40, seed=12, coin_mode="weak_common", coin_eps=1.0), 2,
     True),
], ids=["crash", "byzantine", "textbook", "nofreeze", "equivocate", "common",
        "weak", "private-multiround", "byzantine-textbook-nofreeze",
        "weak-eps1"])
@prefetch(lambda kw, min_rounds, coins: [_match_call(kw)])
def test_unfused_matches_jax(cf_regime, kw, min_rounds, coins):
    tc = bt.SimConfig(**_kw(**kw))
    assert not tsim.tally.pallas_round_active(tc)
    vals = balanced_inputs(T, N)
    jr, jfields = ref(*_match_call(kw))
    tr, tst, _ = bt.simulate(tc, vals, faults=_faults(tc, TFaults),
                             device="cpu")
    assert tr == jr
    assert tr >= min_rounds
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)
    if coins:
        assert _coin_committed(tc, _faults(tc, TFaults))


@pytest.mark.parametrize("kw", [
    dict(n_faulty=24, seed=3),
    dict(n_faulty=40, seed=1),
    dict(n_faulty=40, seed=10, fault_model="byzantine", rule="textbook",
         freeze_decided=False),
])
def test_unfused_matches_packed(cf_regime, kw):
    """Both loops draw the same streams, so they agree bit for bit."""
    outs = []
    for use_round in (False, True):
        cfg = bt.SimConfig(**_kw(use_round, **kw))
        assert tsim.tally.pallas_round_active(cfg) == use_round
        outs.append(bt.simulate(cfg, balanced_inputs(T, N),
                                faults=_faults(cfg, TFaults), device="cpu"))
    (ra, fa, _), (rb, fb, _) = outs
    assert ra == rb
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(fa, name), getattr(fb, name)), name


@pytest.mark.parametrize("use_round", [False, True])
def test_slices_and_resume_match_one_shot(cf_regime, use_round):
    # 40 byzantine lanes, textbook, no freeze: runs to the 24-round cap
    cfg = bt.SimConfig(**_kw(use_round, n_faulty=40, seed=10,
                             fault_model="byzantine", rule="textbook",
                             freeze_decided=False))
    faults = TFaults.first_f(cfg)
    state0 = bt.init_state(cfg, balanced_inputs(T, N), faults)
    rounds, final = bt.run_consensus(cfg, state0, faults)
    assert rounds == cfg.max_rounds

    r, st = 1, tsim.start_state(cfg, state0)
    mid = None
    while True:
        nxt, st = tsim.run_consensus_slice(cfg, st, faults, r, r + 5)
        if nxt == r:
            break
        assert nxt - r <= 5
        r = nxt
        if mid is None:
            mid = (r, st)
    assert r - 1 == rounds
    rr, rfin = tsim.resume_consensus(cfg, mid[1], faults, mid[0])
    assert rr == rounds
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(st, name), getattr(final, name)), name
        assert torch.equal(getattr(rfin, name), getattr(final, name)), name


def test_cpu_run_launches_no_kernel(cf_regime):
    thist.reset_launches()
    tround.reset_launches()
    for kw in (dict(n_faulty=40, seed=9, coin_mode="weak_common",
                    coin_eps=0.5),
               dict(n_faulty=20, seed=19, fault_model="equivocate"),
               dict(n_faulty=24, seed=3)):
        cfg = bt.SimConfig(**_kw(**kw))
        bt.simulate(cfg, balanced_inputs(T, N), faults=_faults(cfg, TFaults),
                    device="cpu")
    assert all(f.launches == 0 for f in thist.KERNELS.values())
    assert all(f.launches == 0 for f in tround.KERNELS.values())


@pytest.mark.parametrize("kw", [
    dict(fault_model="crash_recover", recovery="stagger:2:3:amnesia"),
    dict(fault_model="crash_at_round"),
])
def test_unfused_round_bound_models_run(cf_regime, kw):
    """crash_recover and crash_at_round (the first F = 40 lanes die at
    round 2) on the unfused loop equal the packed loop run for run."""
    outs = []
    for use_round in (False, True):
        cfg = bt.SimConfig(**_kw(use_round, n_faulty=40, seed=1, **kw))
        faults = (crash_recover_faults(cfg)
                  if cfg.fault_model == "crash_recover"
                  else TFaults.first_f(cfg, crash_rounds=[2] * 40
                                       + [0] * (N - 40)))
        outs.append(bt.simulate(cfg, balanced_inputs(T, N), faults=faults,
                                device="cpu"))
    (ur, ust, _), (pr_, pst, _) = outs
    assert ur == pr_ >= 2
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(ust, name), getattr(pst, name)), name


@pytest.mark.parametrize("kw,item", [
    (dict(scheduler="biased", adversary_strength=0.5), "4"),
    (dict(scheduler="biased", adversary_strength=1.0), "4"),
    (dict(delivery="all", drop_prob=0.2), "13"),   # binomial thinning
    (dict(use_pallas_hist=False), "4"),
    (dict(n_faulty=93), "4"),                  # quorum 3: the exact table
])
def test_unfused_unsupported_regimes_raise(cf_regime, kw, item):
    """The regimes that once raised here, naming ROADMAP item ``item``, now
    run on the unfused loop (the plain samplers of ops/sampling.py, the
    biased scheduler's forms, binomial thinning): no gap is left, no
    kernel is reached, and the run ends in a valid state
    (tests/test_torch_hist_regimes.py holds such runs against JAX)."""
    base = _kw(n_faulty=24)
    base.update(kw)
    cfg = bt.SimConfig(**base)
    assert tbenor.round_gap(cfg) is None
    thist.reset_launches()
    rounds, st, _ = bt.simulate(cfg, balanced_inputs(T, N),
                                faults=TFaults.none(T, N), device="cpu")
    assert 1 <= rounds <= cfg.max_rounds
    assert all(fn.launches == 0 for fn in thist.KERNELS.values())
    assert not bool((st.decided & (st.x == 2)).any())
    assert bool(((st.k >= 1) & (st.k <= rounds + 1)).all())


@pytest.mark.parametrize("kw", [
    dict(scheduler="adversarial"),
    dict(scheduler="adversarial", coin_mode="common"),
    dict(scheduler="targeted"),
], ids=["adversarial", "adversarial-common", "targeted"])
@prefetch(lambda kw: [(_jax_run, {**_kw(n_faulty=24), **kw}, "none")])
def test_unfused_adversaries_run_and_match_jax(cf_regime, kw):
    """The count-controlling adversaries run on the unfused loop (their
    closed-form counts), equal to the JAX package's unfused run."""
    base = _kw(n_faulty=24)
    base.update(kw)
    tc = bt.SimConfig(**base)
    vals = balanced_inputs(T, N)
    jr, jfields = ref(_jax_run, base, "none")
    tr, tst, _ = bt.simulate(tc, vals, faults=TFaults.none(T, N),
                             device="cpu")
    assert tr == jr >= 1
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(path="dense"),
    dict(path="dense", scheduler="biased", adversary_strength=0.5),
], ids=["dense", "dense-biased"])
def test_unfused_dense_regimes_run(cf_regime, kw):
    """The dense path and its biased scheduler run on the unfused loop."""
    base = _kw(n_faulty=24)
    base.update(kw)
    cfg = bt.SimConfig(**base)
    rounds, final, _ = bt.simulate(cfg, balanced_inputs(T, N),
                                   faults=TFaults.none(T, N), device="cpu")
    assert 1 <= rounds <= cfg.max_rounds
    assert bool(final.decided.all())
