"""End to end on the dense delivery path: the dense branch of
benor_tpu_torch.ops.tally.receiver_counts against the JAX package's, and
benor_tpu_torch.simulate(..., device="cpu") against benor_tpu.sim.simulate —
rounds, x, decided, k and killed exactly equal per trial — for each
scheduler, fault model, coin and rule of the slice, with ``use_pallas`` on
(the JAX side runs its Pallas kernel in interpret mode) and off; runs in
slices and resumed runs against the one-shot run; the no-kernel rule on the
CPU.  The JAX tally runs under ``jax.jit`` on numpy inputs, to keep the test
process's XLA compile count low."""

import numpy as np
import pytest
import torch

import jax

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import tally as jtally
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.faults import crash_recover_faults
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import hist as thist
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs
from torch_ref_pool import prefetch, ref, start

FIELDS = ("x", "decided", "k", "killed")

J_RECEIVER_COUNTS = jax.jit(jtally.receiver_counts, static_argnums=0)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _jax_run(kw, faults, vals):
    """The JAX package's run: rounds and the final fields (a worker's
    call, see torch_ref_pool)."""
    jc = JCfg(**kw)
    t, n = jc.trials, jc.n_nodes
    jf = JFaults.first_f(jc) if faults == "first_f" else JFaults.none(t, n)
    jr, jst, _ = jsim.simulate(jc, vals, faults=jf)
    return int(jr), {name: np.asarray(getattr(jst, name)) for name in FIELDS}


def _run_call(kw, faults="first_f", vals=None):
    if vals is None:
        vals = balanced_inputs(kw["trials"], kw["n_nodes"])
    return (_jax_run, kw, faults, vals)


def _assert_same_run(kw, faults="first_f", vals=None, min_rounds=1):
    jc, tc = JCfg(**kw), bt.SimConfig(**kw)
    assert tc.resolved_path == jc.resolved_path == "dense"
    assert ttally.dense_gather_needed(tc) and jtally.dense_gather_needed(jc)
    assert not ttally.pallas_round_active(tc)
    t, n = tc.trials, tc.n_nodes
    call = _run_call(kw, faults, vals)
    vals = call[3]
    tf = TFaults.first_f(tc) if faults == "first_f" else TFaults.none(t, n)
    jr, jfields = ref(*call)
    tr, tst, _ = bt.simulate(tc, vals, faults=tf, device="cpu")
    assert tr == jr
    assert tr >= min_rounds
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)
    return tr, tst


# --- receiver_counts, one tally ------------------------------------------


_RC_KW = [
    dict(fault_model="crash"),
    dict(fault_model="byzantine"),
    dict(fault_model="equivocate"),
    dict(fault_model="crash", scheduler="biased", adversary_strength=1.0),
    dict(fault_model="crash", delivery="all", drop_prob=0.2),
]


def _rc_inputs(kw, use_pallas):
    t, n, f = 3, 48, 12
    base = dict(n_nodes=n, n_faulty=f, trials=t, delivery="quorum",
                path="dense", use_pallas=use_pallas, seed=6)
    base.update(kw)
    rs = np.random.default_rng(17)
    sent = rs.integers(0, 3, (t, n)).astype(np.int8)
    alive = rs.random((t, n)) < 0.9
    equiv = (rs.random((t, n)) < 0.25) \
        if base.get("fault_model") == "equivocate" else None
    return base, sent, alive, equiv


def _jax_receiver_counts(base, sent, alive, equiv):
    """The JAX tally at (r, phase) = (1, 0) and (3, 1), under ``jax.jit``
    (a worker's call)."""
    jc = JCfg(**base)
    return [np.asarray(J_RECEIVER_COUNTS(
        jc, jax.random.key(jc.seed), r, phase, sent, alive, equiv=equiv))
        for r, phase in ((1, 0), (3, 1))]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["matmul", "kernel"])
@pytest.mark.parametrize("kw", _RC_KW,
                         ids=["crash", "byzantine", "equivocate", "biased",
                              "omission"])
@prefetch(lambda kw, use_pallas: [(_jax_receiver_counts,
                                   *_rc_inputs(kw, use_pallas))])
def test_dense_receiver_counts_match_jax(kw, use_pallas):
    base, sent, alive, equiv = _rc_inputs(kw, use_pallas)
    tc = bt.SimConfig(**base)
    t, n = tc.trials, tc.n_nodes
    wants = ref(_jax_receiver_counts, base, sent, alive, equiv)
    for (r, phase), want in zip(((1, 0), (3, 1)), wants):
        got = ttally.receiver_counts(
            tc, tc.seed, r, phase, torch.from_numpy(sent),
            torch.from_numpy(alive),
            None if equiv is None else torch.from_numpy(equiv))
        assert got.dtype == torch.int32 and tuple(got.shape) == (t, n, 3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_receiver_counts_global_ids_key_the_streams():
    """A receiver shard keyed by its global ids tallies what the whole
    network's run tallies for those receivers."""
    t, n = 2, 32
    cfg = bt.SimConfig(n_nodes=n, n_faulty=8, trials=t, delivery="quorum",
                       path="dense", seed=2)
    rs = np.random.default_rng(4)
    sent = torch.from_numpy(rs.integers(0, 3, (t, n)).astype(np.int8))
    alive = torch.ones((t, n), dtype=torch.bool)
    alive[:, 3:6] = False
    whole = ttally.receiver_counts(cfg, 2, 1, 0, sent, alive)
    same = ttally.receiver_counts(cfg, 2, 1, 0, sent, alive,
                                  trial_ids=torch.arange(t),
                                  recv_ids=torch.arange(n))
    moved = ttally.receiver_counts(cfg, 2, 1, 0, sent, alive,
                                   trial_ids=torch.arange(t) + 5)
    assert torch.equal(whole, same)
    assert not torch.equal(whole, moved)
    assert (whole.sum(-1) == cfg.quorum).all()     # 29 alive >= 24


# --- simulate ----------------------------------------------------------------


def _n60(use_pallas):
    """N = 60, F = 15, 16 trials, iid inputs, crash faults from birth."""
    n, f, trials = 60, 15, 16
    vals = np.random.default_rng(3).integers(0, 2, (trials, n), np.int8)
    return dict(n_nodes=n, n_faulty=f, trials=trials, max_rounds=48,
                delivery="quorum", scheduler="uniform", path="dense", seed=3,
                use_pallas=use_pallas), vals


@pytest.mark.parametrize("use_pallas", [False, True], ids=["matmul", "kernel"])
@prefetch(lambda use_pallas: [_run_call(_n60(use_pallas)[0],
                                        vals=_n60(use_pallas)[1])])
def test_dense_n60_matches_jax(use_pallas):
    """N = 60, F = 15, 16 trials, iid inputs, crash faults from birth."""
    kw, vals = _n60(use_pallas)
    _assert_same_run(kw, vals=vals)


_N10 = dict(n_nodes=10, n_faulty=4, trials=1, max_rounds=20,
            delivery="quorum", seed=1)


@pytest.mark.parametrize("vals", [[1] * 10, [0, 1] * 5, [1] * 4 + [0] * 6],
                         ids=["unanimous", "balanced", "skewed"])
@prefetch(lambda vals: [_run_call(_N10, vals=vals)])
def test_auto_path_at_n10_matches_jax(vals):
    """path='auto' at the upstream repo's own size: N = 10, F = 4."""
    _assert_same_run(_N10, vals=vals)


_B96 = dict(n_nodes=96, n_faulty=40, trials=4, max_rounds=24,
            delivery="quorum", path="dense")


@pytest.mark.parametrize("kw,faults,min_rounds", [
    (dict(seed=1), "none", 2),
    (dict(seed=7, coin_mode="common"), "none", 2),
    (dict(seed=9, coin_mode="weak_common", coin_eps=0.5), "none", 2),
    (dict(seed=1, scheduler="biased", adversary_strength=0.5), "none", 2),
    (dict(seed=1, scheduler="biased", adversary_strength=1.0), "none", 1),
    (dict(seed=19, n_faulty=20, fault_model="equivocate"), "first_f", 1),
    (dict(seed=15, n_faulty=20, fault_model="byzantine"), "first_f", 1),
    (dict(seed=5, n_faulty=30, rule="textbook"), "first_f", 1),
    (dict(seed=10, fault_model="byzantine", rule="textbook",
          freeze_decided=False), "first_f", 2),
    (dict(seed=11, n_faulty=24, freeze_decided=False), "first_f", 1),
    (dict(seed=1, n_faulty=20, delivery="all", drop_prob=0.2), "none", 2),
    (dict(seed=2, n_faulty=20, delivery="all", drop_prob=0.2,
          use_pallas=True), "first_f", 1),
], ids=["private", "common", "weak", "biased0.5", "biased1.0", "equivocate",
        "byzantine", "textbook", "byzantine-textbook-nofreeze", "nofreeze",
        "omission", "omission-crash-kernel"])
@prefetch(lambda kw, faults, min_rounds: [_run_call({**_B96, **kw}, faults)])
def test_dense_n96_matches_jax(kw, faults, min_rounds):
    _assert_same_run({**_B96, **kw}, faults=faults, min_rounds=min_rounds)


def test_dense_coin_modes_take_different_coins():
    """At N = 96, F = 40 balanced the first round decides nothing, so the
    coin is drawn: the three coin modes end in different states."""
    finals = []
    for kw in (dict(), dict(coin_mode="common"),
               dict(coin_mode="weak_common", coin_eps=0.5)):
        cfg = bt.SimConfig(**{**_B96, "seed": 1, "max_rounds": 1, **kw})
        _, st, _ = bt.simulate(cfg, balanced_inputs(4, 96),
                               faults=TFaults.none(4, 96), device="cpu")
        assert not bool(st.decided.any())
        finals.append(st.x)
    assert not torch.equal(finals[0], finals[1])
    assert not torch.equal(finals[0], finals[2])
    assert not torch.equal(finals[1], finals[2])


@pytest.mark.parametrize("kw", [
    dict(seed=10, fault_model="byzantine", rule="textbook",
         freeze_decided=False),
    dict(seed=1, n_faulty=20, delivery="all", drop_prob=0.2),
], ids=["quorum", "omission"])
def test_dense_slices_and_resume_match_one_shot(kw):
    cfg = bt.SimConfig(**{**_B96, **kw})
    faults = TFaults.first_f(cfg) if cfg.fault_model == "byzantine" \
        else TFaults.none(4, 96)
    state0 = bt.init_state(cfg, balanced_inputs(4, 96), faults)
    rounds, final = bt.run_consensus(cfg, state0, faults)
    assert rounds >= 6

    r, st = 1, tsim.start_state(cfg, state0)
    mid = None
    while True:
        nxt, st = bt.run_consensus_slice(cfg, st, faults, r, r + 5)
        if nxt == r:
            break
        assert nxt - r <= 5
        r = nxt
        if mid is None:
            mid = (r, st)
    assert r - 1 == rounds
    rr, rfin = bt.resume_consensus(cfg, mid[1], faults, mid[0])
    assert rr == rounds
    for name in FIELDS:
        assert torch.equal(getattr(st, name), getattr(final, name)), name
        assert torch.equal(getattr(rfin, name), getattr(final, name)), name


def test_dense_use_pallas_on_equals_off():
    outs = []
    for use_pallas in (False, True):
        cfg = bt.SimConfig(**{**_B96, "seed": 1, "use_pallas": use_pallas})
        outs.append(bt.simulate(cfg, balanced_inputs(4, 96),
                                faults=TFaults.none(4, 96), device="cpu"))
    (ra, fa, _), (rb, fb, _) = outs
    assert ra == rb >= 2
    for name in FIELDS:
        assert torch.equal(getattr(fa, name), getattr(fb, name)), name


def test_dense_cpu_run_launches_no_kernel():
    tdense.reset_launches()
    thist.reset_launches()
    for kw in (dict(seed=1, use_pallas=True),
               dict(seed=19, n_faulty=20, fault_model="equivocate",
                    use_pallas=True),
               dict(seed=1, n_faulty=20, delivery="all", drop_prob=0.2,
                    use_pallas=True)):
        cfg = bt.SimConfig(**{**_B96, **kw})
        bt.simulate(cfg, balanced_inputs(4, 96), faults=TFaults.none(4, 96),
                    device="cpu")
    assert tdense.dense_counts.launches == 0
    assert all(f.launches == 0 for f in thist.KERNELS.values())


@pytest.mark.parametrize("kw", [
    dict(fault_model="crash_recover", recovery="at:1:3:amnesia"),
    dict(scheduler="targeted", fault_model="crash_at_round"),
    dict(fault_model="crash_at_round"),
])
def test_dense_round_bound_models_run(kw):
    """crash_at_round (the first F lanes die at round 2) and crash_recover
    run on the dense path; the tally's kernel route (``use_pallas``, its
    plain version here) equals the f32 matrix product run for run."""
    outs = []
    for use_pallas in (True, False):
        cfg = bt.SimConfig(**{**_B96, **kw, "use_pallas": use_pallas})
        assert cfg.resolved_path == "dense"
        f = cfg.n_faulty
        faults = (crash_recover_faults(cfg)
                  if cfg.fault_model == "crash_recover"
                  else TFaults.first_f(cfg, crash_rounds=[2] * f
                                       + [0] * (96 - f)))
        rounds, st, _ = bt.simulate(cfg, balanced_inputs(4, 96),
                                    faults=faults, device="cpu")
        assert rounds >= 2
        outs.append((rounds, st))
    assert outs[0][0] == outs[1][0]
    for name in FIELDS:
        assert torch.equal(getattr(outs[0][1], name),
                           getattr(outs[1][1], name)), name


@pytest.mark.parametrize("kw,item", [
    (dict(delivery="all", committee_cap=4, committee_count=2,
          committee_size=8), None),
    (dict(delivery="all", drop_prob=0.2, path="histogram"), None),
    (dict(scheduler="biased", adversary_strength=1.0, path="histogram"),
     None),
])
def test_dense_neighbours_still_raise(kw, item):
    """The neighbours of the dense slice that once raised here run now
    (``item`` None): committees at a dense-path size (their own tally,
    held against JAX in tests/test_torch_topo.py), omission and the
    biased scheduler on the histogram path (binomial thinning and the
    strict-priority sampler, held against JAX in
    tests/test_torch_hist_regimes.py)."""
    assert item is None
    cfg = bt.SimConfig(**{**_B96, **kw})
    args = (cfg, balanced_inputs(4, 96))
    kw = dict(faults=TFaults.none(4, 96), device="cpu")
    rounds, st, _ = bt.simulate(*args, **kw)
    assert 1 <= rounds <= cfg.max_rounds
    assert not bool((st.decided & (st.x == 2)).any())


@pytest.mark.parametrize("kw", [
    dict(scheduler="adversarial"),
    dict(scheduler="targeted"),
], ids=["adversarial", "targeted"])
@prefetch(lambda kw: [_run_call({**_B96, "seed": 5, **kw}, "none")])
def test_dense_adversaries_run_and_match_jax(kw):
    """The count-controlling adversaries at a dense-path size: closed-form
    counts on the unfused loop, no mask drawn, equal to the JAX package's
    run."""
    base = {**_B96, "seed": 5, **kw}
    tc = bt.SimConfig(**base)
    assert not ttally.dense_gather_needed(tc) or tc.scheduler == "targeted"
    vals = balanced_inputs(4, 96)
    jr, jfields = ref(*_run_call(base, "none"))
    tr, tst, _ = bt.simulate(tc, vals, faults=TFaults.none(4, 96),
                             device="cpu")
    assert tr == jr >= 1
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      jfields[name], err_msg=name)
