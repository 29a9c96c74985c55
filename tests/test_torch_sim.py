"""End to end: benor_tpu_torch.simulate(..., device="cpu") against
benor_tpu.sim.simulate on the packed main path — rounds, x, decided and k
exactly equal per trial — and the port's no-fallback rules."""

import warnings

import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import pallas_round as jround
from benor_tpu.ops import sampling as jsampling
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu.sweep import balanced_inputs as j_balanced
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.faults import crash_recover_faults
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs, random_inputs
from torch_ref_pool import prefetch, ref, start

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


def _kw(n, t, **kw):
    kw.setdefault("max_rounds", 24)
    return dict(n_nodes=n, trials=t, delivery="quorum", scheduler="uniform",
                path="histogram", use_pallas_hist=True,
                use_pallas_round=True, **kw)


def _jax_run(kw, vals, faults, cf):
    """The JAX package's run, in the CF regime (EXACT_TABLE_MAX = 4, as
    ``cf_regime``) where ``cf``; ``faults`` is "none", "first_f" or a
    faulty list (a worker's call, see torch_ref_pool)."""
    old = jsampling.EXACT_TABLE_MAX
    if cf:
        jsampling.EXACT_TABLE_MAX = 4
    try:
        jc = JCfg(**kw)
        t, n = jc.trials, jc.n_nodes
        if faults == "none":
            jout = jsim.simulate(jc, vals, faults=JFaults.none(t, n))
        elif faults == "first_f":
            jout = jsim.simulate(jc, vals, faults=JFaults.first_f(jc))
        else:
            jout = jsim.simulate(jc, vals, faults)
        return int(jout[0]), {name: np.asarray(getattr(jout[1], name))
                              for name in FIELDS}
    finally:
        jsampling.EXACT_TABLE_MAX = old


def _assert_same(jout, tout, min_rounds=1):
    (jr, jfields), (tr, tst, _) = jout, tout
    assert tr == jr
    assert tr >= min_rounds
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)


_MATCH_CASES = [
    (dict(n_faulty=24, seed=3), True, 1),                    # crash-from-birth
    (dict(n_faulty=40, seed=1), False, 2),                   # multi-round
    (dict(n_faulty=0, seed=2), False, 1),
    (dict(n_faulty=30, seed=5, rule="textbook"), True, 1),
    (dict(n_faulty=24, seed=11, freeze_decided=False), True, 1),
    (dict(n_faulty=20, seed=13, fault_model="byzantine"), True, 1),
]


def _match_call(kw, crash):
    n, t = 96, (4 if kw["n_faulty"] == 40 else 8)
    vals = balanced_inputs(t, n)
    fl = ([True] * kw["n_faulty"] + [False] * (n - kw["n_faulty"])
          if crash else "none")
    return (_jax_run, _kw(n, t, **kw), vals, fl, True)


@pytest.mark.parametrize("kw,crash,min_rounds", _MATCH_CASES)
@prefetch(lambda kw, crash, min_rounds: [_match_call(kw, crash)])
def test_simulate_matches_jax(cf_regime, kw, crash, min_rounds):
    n, t = 96, (4 if kw["n_faulty"] == 40 else 8)
    tc = bt.SimConfig(**_kw(n, t, **kw))
    assert tround.fused_one_pass_eligible(tc, t, n)
    vals = balanced_inputs(t, n)
    np.testing.assert_array_equal(vals, j_balanced(t, n))
    jout = ref(*_match_call(kw, crash))
    if crash:
        fl = [True] * tc.n_faulty + [False] * (n - tc.n_faulty)
        tout = bt.simulate(tc, vals, fl, device="cpu")
    else:
        tout = bt.simulate(tc, vals, faults=TFaults.none(t, n), device="cpu")
    _assert_same(jout, tout, min_rounds)


_TWO_KW = _kw(9000, 2, n_faulty=4000, seed=4, max_rounds=3)


@prefetch(lambda: [(_jax_run, _TWO_KW, random_inputs(7, 2, 9000), "none",
                    False)])
def test_simulate_two_kernel_dispatch_matches_jax():
    """N = 9000 pads to 9216 > the one-pass cap: both packages take the
    proposal + vote kernel pair (the N = 1M path's dispatch)."""
    n, t = 9000, 2
    kw = _TWO_KW
    jc, tc = JCfg(**kw), bt.SimConfig(**kw)
    assert not tround.fused_one_pass_eligible(tc, t, n)
    assert not jround.fused_one_pass_eligible(jc, t, n)
    vals = random_inputs(7, t, n)
    jout = ref(_jax_run, kw, vals, "none", False)
    tout = bt.simulate(tc, vals, faults=TFaults.none(t, n), device="cpu")
    _assert_same(jout, tout, 2)


def test_no_gpu_and_no_cpu_request_raises(monkeypatch, cf_regime):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = bt.SimConfig(**_kw(96, 2, n_faulty=24))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.simulate(cfg, balanced_inputs(2, 96))
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.simulate(cfg, balanced_inputs(2, 96), device="cuda")


def test_cpu_run_launches_no_kernel(cf_regime):
    tround.reset_launches()
    cfg = bt.SimConfig(**_kw(96, 2, n_faulty=24))
    bt.simulate(cfg, balanced_inputs(2, 96), faults=TFaults.none(2, 96),
                device="cpu")
    cfg = bt.SimConfig(**_kw(9000, 1, n_faulty=2000, max_rounds=1))
    bt.simulate(cfg, balanced_inputs(1, 9000), faults=TFaults.none(1, 9000),
                device="cpu")
    assert all(f.launches == 0 for f in tround.KERNELS.values())


@pytest.mark.parametrize("kw", [
    dict(use_pallas_round=False, use_pallas_hist=False),
    dict(use_pallas_hist=False),
    dict(mesh_shape=(1, 2)),
    dict(debug=True),
])
def test_unsupported_regimes_raise(cf_regime, kw):
    """mesh_shape raises, naming ROADMAP item 15; the JAX package's
    default sampler (use_pallas_hist=False, the plain CF draws on the
    unfused loop) and debug=True (the packed loop, announced, one event
    a round: tests/test_torch_debug.py) run now."""
    base = _kw(96, 2, n_faulty=24)
    base.update(kw)
    cfg = bt.SimConfig(**base)
    if "mesh_shape" in kw:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A item 15\\)"):
            bt.simulate(cfg, balanced_inputs(2, 96), device="cpu")
        return
    tround.reset_launches()
    with warnings.catch_warnings():
        # debug=True announces its demotion (at most once per process)
        warnings.simplefilter("ignore", UserWarning)
        rounds, st, _ = bt.simulate(cfg, balanced_inputs(2, 96),
                                    faults=TFaults.none(2, 96),
                                    device="cpu")
    assert 1 <= rounds <= cfg.max_rounds
    assert all(fn.launches == 0 for fn in tround.KERNELS.values())
    assert not bool((st.decided & (st.x == 2)).any())


# the observability planes on the packed loop: the armed run's final state
# equals the unarmed run's, and the tails
# come in the JAX package's order (recorder, witness, stage counters);
# tests/test_torch_observability.py holds them against the JAX package
@pytest.mark.parametrize("kw,tails", [
    (dict(record=True), ((25, 7),)),
    (dict(trials=2, witness_trials=(0,), witness_nodes=2), ((25, 1, 2, 9),)),
    (dict(kernel_telemetry=True), ((2, 1, 7),)),
], ids=["record", "witness", "kernel_telemetry"])
def test_observability_regimes_run(cf_regime, kw, tails):
    base = _kw(96, 2, n_faulty=40, seed=1)
    base.update(kw)
    cfg = bt.SimConfig(**base)
    vals, faults = balanced_inputs(2, 96), TFaults.none(2, 96)
    rounds, st, _, *extras = bt.simulate(cfg, vals, faults=faults,
                                         device="cpu")
    plain = bt.SimConfig(**_kw(96, 2, n_faulty=40, seed=1))
    r0, st0, _ = bt.simulate(plain, vals, faults=faults, device="cpu")
    assert rounds == r0 >= 2
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(st, name), getattr(st0, name)), name
    assert [tuple(e.shape) for e in extras] == list(tails)
    assert all(e.dtype == torch.int32 for e in extras)


# the round-bound fault models at F = 40 (crash_at_round: the first F lanes
# die at round 2; crash_recover: 'at:2:3', down for rounds 2-4), each run on the
# loop that serves it and, where both loops share every random bit (the
# uniform scheduler's CF regime, the common coin), equal to the other loop
@pytest.mark.parametrize("kw,exact", [
    (dict(fault_model="crash_at_round", coin_mode="common"), True),
    (dict(fault_model="crash_recover", coin_mode="weak_common",
          coin_eps=0.5), True),
    (dict(fault_model="crash_recover"), True),
    (dict(fault_model="crash_at_round"), True),
    (dict(scheduler="adversarial", fault_model="crash_at_round"), False),
    (dict(path="dense", scheduler="targeted", fault_model="crash_recover"),
     False),
])
def test_round_bound_regimes_run(cf_regime, kw, exact):
    base = _kw(96, 2, n_faulty=40, seed=1)
    base.update(kw)
    if base["fault_model"] == "crash_recover":
        base["recovery"] = "at:2:3"
    runs = []
    for use_round in (True, False):
        cfg = bt.SimConfig(**{**base, "use_pallas_round": use_round})
        faults = (crash_recover_faults(cfg)
                  if cfg.fault_model == "crash_recover"
                  else TFaults.first_f(cfg, crash_rounds=[2] * 40 + [0] * 56))
        rounds, st, _ = bt.simulate(cfg, balanced_inputs(2, 96),
                                    faults=faults, device="cpu")
        assert rounds >= (5 if cfg.fault_model == "crash_recover" else 2)
        assert not bool(((st.x == bt.VALQ) & st.decided).any())
        runs.append((rounds, st))
    (pr_, pst), (ur, ust) = runs
    if exact:
        assert pr_ == ur
        for name in ("x", "decided", "k", "killed"):
            assert torch.equal(getattr(pst, name), getattr(ust, name)), name


@pytest.mark.parametrize("kw,crash,against", [
    (dict(coin_mode="common", n_faulty=40, seed=1), False, "jax"),
    (dict(coin_mode="weak_common", coin_eps=0.5, n_faulty=40, seed=1),
     False, "jax"),
    (dict(fault_model="equivocate", n_faulty=20, seed=13), True, "unfused"),
    (dict(scheduler="adversarial", coin_mode="common", n_faulty=24,
          seed=3), False, "unfused"),
    (dict(path="dense", scheduler="targeted", n_faulty=24, seed=3), False,
     "jax"),
], ids=["common", "weak_common", "equivocate", "adversarial",
        "dense-targeted"])
@prefetch(lambda kw, crash, against: [
    (_jax_run, {**_kw(96, 4), **kw}, balanced_inputs(4, 96),
     "first_f" if crash else "none", True)] if against == "jax" else [])
def test_packed_modes_run_and_match_jax(cf_regime, kw, crash, against):
    """The shared coins, equivocation and the count-controlling adversaries
    run on the packed loop: equal to the JAX package's packed run, or, where
    both of the port's loops share every random bit (sampled equivocation
    with the private coin, the common coin under the count adversary), to
    the port's unfused run; tests/test_torch_packed_modes.py holds those two
    against the JAX package's packed run at N = 1000."""
    n, t = 96, 4
    args = {**_kw(n, t), **kw}
    jc, tc = JCfg(**args), bt.SimConfig(**args)
    vals = balanced_inputs(t, n)
    if crash:
        tf = TFaults.first_f(tc)
    else:
        tf = TFaults.none(t, n)
    got = bt.simulate(tc, vals, faults=tf, device="cpu")
    if against == "jax":
        _assert_same(ref(_jax_run, args, vals,
                         "first_f" if crash else "none", True), got)
        return
    tr, tst, _ = bt.simulate(tc.replace(use_pallas_round=False), vals,
                             faults=tf, device="cpu")
    assert got[0] == tr >= 1
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(got[1], name), getattr(tst, name)), name


def test_dense_path_runs(cf_regime):
    """path='dense' is served by the unfused loop whatever the histogram
    kernels' switches say, and equals the run with them off."""
    outs = []
    for kw in (dict(), dict(use_pallas_hist=False, use_pallas_round=False)):
        base = _kw(96, 2, n_faulty=24)
        base.update(path="dense", **kw)
        cfg = bt.SimConfig(**base)
        outs.append(bt.simulate(cfg, balanced_inputs(2, 96),
                                faults=TFaults.none(2, 96), device="cpu"))
    (ra, fa, _), (rb, fb, _) = outs
    assert ra == rb >= 1
    assert bool(fa.decided.all())
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(fa, name), getattr(fb, name)), name
