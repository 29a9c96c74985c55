"""crash_at_round and crash_recover on the port against the JAX package.

The recovery spec grammar (parse_recovery, rejoin_mode, RecoverySpec.rounds,
crash_recover_faults) on a table of valid and malformed specs; the three
round kernels' plain versions against the JAX package's Pallas kernels in
interpret mode on one pack (T = 3, N = 1000 with pad lanes) whose round
bounds put faulty lanes in every class at round 3 (crashing now, down,
never rejoining, rejoining now decided and undecided, back, untouched),
summed partials and new plane stacks (down plane included) exactly equal,
and sent_hist_from_pack with the round; then the loops at N = 96 x 8 in the
CF regime: the port's packed and unfused runs against the JAX package's,
the dense path against the JAX package's, and inside the port 'at:3:0'
against crash_at_round and a sliced run against the one-shot run.  The
JAX side runs op by op on numpy inputs, each kernel compiled once a mode,
and its caches are dropped when the module is done."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu import state as jstate
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.faults import recovery as jrec
from benor_tpu.ops import pallas_round as jround
from benor_tpu.ops import rng as jrng
from benor_tpu.ops import sampling as jsampling
from benor_tpu.ops import tally as jtally
from benor_tpu.ops.collectives import SINGLE
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import convert
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.faults import recovery as trec
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.state import PACK_DOWN, PACK_KILLED, PACK_X
from benor_tpu_torch.sweep import balanced_inputs

FIELDS = ("x", "decided", "k", "killed")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Every XLA:CPU executable keeps memory maps, and a test process that
    holds too many dies in a later compile: drop this module's when it is
    done."""
    yield
    jax.clear_caches()


@pytest.fixture
def cf_regime():
    """Force the CF regime at small N in BOTH packages (quorum > 4)."""
    old = jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = tsampling.EXACT_TABLE_MAX = 4
    try:
        yield
    finally:
        jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX = old


# --- the recovery grammar ----------------------------------------------------

SPECS = [None, "at:2:3", "at:2:3:amnesia", "at:2:0", "at:1:4:durable",
         "stagger:1:4:amnesia", "stagger:3:2", "at:0:3", "at:2:-1", "at:2",
         "at:x:3", "ring:2:3", "at:2:3:foo", "stagger:1:4:amnesia:durable"]


def _grammar(mod, spec):
    try:
        p = mod.parse_recovery(spec)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", None if p is None else dataclasses.astuple(p),
            mod.rejoin_mode(spec), None if p is None else p.rounds(5))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_recovery_grammar_matches_jax(spec):
    assert _grammar(trec, spec) == _grammar(jrec, spec)
    assert trec.REJOIN_MODES == jrec.REJOIN_MODES


def test_crash_recover_faults_match_jax():
    kw = dict(n_nodes=12, n_faulty=5, trials=2,
              fault_model="crash_recover", recovery="stagger:2:3:amnesia")
    jf = jrec.crash_recover_faults(JCfg(**kw))
    tf = trec.crash_recover_faults(bt.SimConfig(**kw))
    for name in ("faulty", "crash_round", "recover_round"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    with pytest.raises(ValueError, match="recovery schedule"):
        trec.crash_recover_faults(bt.SimConfig(
            n_nodes=12, n_faulty=5, fault_model="crash_recover"))


# --- the three kernels' plain versions against the Pallas kernels ---------

R = 3
T, N = 3, 1000
NP = 1024
EPS = 0.5


@pytest.fixture(scope="module")
def fixture():
    """A random mid-run state packed by both packages (0.45 of the lanes
    faulty) and the round bounds: crash rounds in {0, 1..6}, recover rounds
    in {0, cr + 1 .. cr + 4}, pad lanes 0."""
    rs = np.random.default_rng(21)
    leaves = dict(x=rs.integers(0, 3, size=(T, N)).astype(np.int8),
                  decided=rs.random((T, N)) < 0.2,
                  k=rs.integers(0, 10, size=(T, N)).astype(np.int32),
                  killed=rs.random((T, N)) < 0.1)
    faulty = rs.random((T, N)) < 0.45
    cr = np.zeros((T, NP), np.int32)
    cr[:, :N] = rs.integers(0, 7, size=(T, N))
    d = rs.integers(0, 5, size=(T, NP))
    rcv = np.where(d > 0, cr + d, 0).astype(np.int32)
    rcv[:, N:] = 0
    jc = JCfg(n_nodes=N, n_faulty=400, trials=T, max_rounds=12)
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jpack = jround.pack_state(jc, jst, jnp.asarray(faulty))
    tpack = tround.pack_state(bt.SimConfig(n_nodes=N, n_faulty=400,
                                           trials=T, max_rounds=12),
                              convert.state_from_numpy(**leaves),
                              torch.from_numpy(faulty))
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack),
                                  np.asarray(jpack))
    # every class of faulty lane occurs at round R
    fau = np.zeros((T, NP), bool)
    fau[:, :N] = faulty
    dec = np.zeros((T, NP), bool)
    dec[:, :N] = leaves["decided"]
    started = fau & (cr > 0) & (R >= cr)
    now = fau & (cr > 0) & (rcv == R)
    for cls in (fau & (cr == R), started & (rcv <= 0), started & (rcv > R),
                started & (rcv > 0) & (rcv < R), now & dec, now & ~dec,
                fau & (cr == 0), fau & (cr > R)):
        assert cls.any()
    shared = rs.integers(0, 2, size=T).astype(np.int32)
    hist2 = rs.integers(0, N // 2, size=(T, 3)).astype(np.int32)
    return dict(jpack=jpack, tpack=tpack, cr=cr, rcv=rcv, shared=shared,
                hist2=hist2)


def _cfgs(fault_model, rejoin, counts_mode="sampled"):
    sched = {"sampled": "uniform", "delivered": "adversarial",
             "camps": "targeted"}[counts_mode]
    kw = dict(n_nodes=N, n_faulty=400, trials=T, max_rounds=12,
              fault_model=fault_model, delivery="quorum", scheduler=sched,
              recovery=(f"at:1:4:{rejoin}" if fault_model == "crash_recover"
                        else None))
    return JCfg(**kw), bt.SimConfig(**kw)


def _bounds(fx, fault_model):
    """The round bounds as (JAX arrays, port tensors)."""
    rcv = fault_model == "crash_recover"
    j = (jnp.asarray(fx["cr"]), jnp.asarray(fx["rcv"]) if rcv else None)
    t = (torch.from_numpy(fx["cr"]),
         torch.from_numpy(fx["rcv"]) if rcv else None)
    return j, t


def _counts(jc, tc, hist, counts_mode):
    """A phase's counts in counts_mode's layout by both packages' closed
    forms (numpy in)."""
    th = torch.from_numpy(np.array(hist))
    if counts_mode == "delivered":
        return (jtally.adversarial_counts(jnp.asarray(hist), jc.quorum),
                ttally.adversarial_counts(th, tc.quorum))
    if counts_mode == "camps":
        return (jtally.targeted_camp_triples(jc, jnp.asarray(hist)),
                ttally.targeted_camp_triples(tc, th))
    return jnp.asarray(hist), th


@pytest.mark.parametrize("fault_model,rejoin", [
    ("crash_at_round", "durable"), ("crash_recover", "durable"),
    ("crash_recover", "amnesia")])
def test_sent_hist_with_the_round_matches_jax(fixture, fault_model, rejoin):
    jc, tc = _cfgs(fault_model, rejoin)
    (jcr, jrcv), (tcr, trcv) = _bounds(fixture, fault_model)
    for r in (1, R, 6):
        want = jround.sent_hist_from_pack(jc, fixture["jpack"], jcr, jrcv, r,
                                          SINGLE)
        got = tround.sent_hist_from_pack(tc, fixture["tpack"], tcr, trcv, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (fault model, rejoin, counts mode, coin)
PROPOSAL_CASES = [("crash_at_round", "durable", "sampled", "private"),
                  ("crash_recover", "durable", "sampled", "private"),
                  ("crash_recover", "amnesia", "sampled", "private"),
                  ("crash_at_round", "durable", "delivered", "private"),
                  ("crash_at_round", "durable", "camps", "private")]
VOTE_CASES = [("crash_at_round", "durable", "sampled", "private"),
              ("crash_recover", "durable", "sampled", "common"),
              ("crash_recover", "amnesia", "sampled", "weak_common"),
              ("crash_at_round", "durable", "delivered", "common"),
              ("crash_at_round", "durable", "camps", "private"),
              ("crash_recover", "amnesia", "camps", "private")]
FUSED_CASES = [("crash_at_round", "durable", "sampled", "private"),
               ("crash_recover", "durable", "sampled", "private"),
               ("crash_recover", "amnesia", "sampled", "common")]


def _ids(cases):
    return ["-".join(c) for c in cases]


def _camps(tc, counts_mode):
    return (ttally.targeted_camp_bounds(tc) if counts_mode == "camps"
            else (0, 0))


@pytest.mark.parametrize("fault_model,rejoin,counts_mode,coin_mode",
                         PROPOSAL_CASES, ids=_ids(PROPOSAL_CASES))
def test_proposal_matches_pallas(fixture, fault_model, rejoin, counts_mode,
                                 coin_mode):
    jc, tc = _cfgs(fault_model, rejoin, counts_mode)
    (jcr, jrcv), (tcr, trcv) = _bounds(fixture, fault_model)
    hist = np.asarray(jround.sent_hist_from_pack(jc, fixture["jpack"], jcr,
                                                 jrcv, R, SINGLE))
    jcounts, tcounts = _counts(jc, tc, hist, counts_mode)
    b0, b1 = _camps(tc, counts_mode)
    want = jround.proposal_hist_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_PROPOSAL, jcounts,
        fixture["jpack"], jcr, jc.quorum, fault_model, True, interpret=True,
        counts_mode=counts_mode, camp_b0=b0, camp_b1=b1, recover_round=jrcv,
        rejoin=rejoin)
    got = tround.proposal_hist(
        tc.seed, R, trng.PHASE_PROPOSAL, tcounts, fixture["tpack"],
        tc.quorum, fault_model, True, counts_mode=counts_mode, camp_b0=b0,
        camp_b1=b1, crash_round=tcr, recover_round=trcv, rejoin=rejoin)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want)[:, :tround.PROP_COLS])


@pytest.mark.parametrize("fault_model,rejoin,counts_mode,coin_mode",
                         VOTE_CASES, ids=_ids(VOTE_CASES))
def test_vote_matches_pallas(fixture, fault_model, rejoin, counts_mode,
                             coin_mode):
    jc, tc = _cfgs(fault_model, rejoin, counts_mode)
    (jcr, jrcv), (tcr, trcv) = _bounds(fixture, fault_model)
    jcounts, tcounts = _counts(jc, tc, fixture["hist2"], counts_mode)
    b0, b1 = _camps(tc, counts_mode)
    qok = np.arange(T) % 3 != 2
    eps = EPS if coin_mode == "weak_common" else 0.0
    jpack2, jparts = jround.vote_commit_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_VOTE, jcounts,
        fixture["jpack"], jcr, jnp.asarray(qok),
        jnp.asarray(fixture["shared"]), jc.quorum, jc.n_faulty, "reference",
        coin_mode, eps, True, fault_model, interpret=True,
        counts_mode=counts_mode, camp_b0=b0, camp_b1=b1, recover_round=jrcv,
        rejoin=rejoin)
    tpack2, tparts = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, tcounts, fixture["tpack"],
        torch.from_numpy(qok), tc.quorum, tc.n_faulty, "reference",
        fault_model, True, counts_mode=counts_mode, camp_b0=b0, camp_b1=b1,
        coin_mode=coin_mode, eps=eps,
        shared=torch.from_numpy(fixture["shared"]), crash_round=tcr,
        recover_round=trcv, rejoin=rejoin)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2),
                                  np.asarray(jpack2))
    np.testing.assert_array_equal(tparts.numpy(),
                                  np.asarray(jparts)[:, :tround.VOTE_COLS])
    # the round's update reached the stack: latched killed lanes and, under
    # crash_recover, a down plane
    assert (tpack2[:, PACK_KILLED] != fixture["tpack"][:, PACK_KILLED]).any()
    assert bool(tpack2[:, PACK_DOWN].ne(0).any()) == (
        fault_model == "crash_recover")


@pytest.mark.parametrize("fault_model,rejoin,counts_mode,coin_mode",
                         FUSED_CASES, ids=_ids(FUSED_CASES))
def test_fused_matches_pallas_and_two_kernel(fixture, fault_model, rejoin,
                                            counts_mode, coin_mode):
    jc, tc = _cfgs(fault_model, rejoin)
    (jcr, jrcv), (tcr, trcv) = _bounds(fixture, fault_model)
    hist = jround.sent_hist_from_pack(jc, fixture["jpack"], jcr, jrcv, R,
                                      SINGLE)
    jout = jround.fused_round_pallas(
        jax.random.key(jc.seed), R, hist, fixture["jpack"], jcr,
        jnp.asarray(fixture["shared"]), jc.quorum, jc.n_faulty, "reference",
        coin_mode, 0.0, True, fault_model, interpret=True,
        recover_round=jrcv, rejoin=rejoin)
    thist = torch.from_numpy(np.array(hist))
    bounds = dict(crash_round=tcr, recover_round=trcv, rejoin=rejoin)
    shared = torch.from_numpy(fixture["shared"])
    tout = tround.fused_round(tc.seed, R, thist, fixture["tpack"], tc.quorum,
                              tc.n_faulty, "reference", fault_model, True,
                              coin_mode=coin_mode, shared=shared, **bounds)
    np.testing.assert_array_equal(convert.pack_to_numpy(tout[0]),
                                  np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(),
                                  np.asarray(jout[1])[:, :tround.PROP_COLS])
    np.testing.assert_array_equal(tout[2].numpy(),
                                  np.asarray(jout[2])[:, :tround.VOTE_COLS])
    # inside the port: fused == proposal + sum + vote, bit for bit
    parts_a = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL, thist,
                                   fixture["tpack"], tc.quorum, fault_model,
                                   True, **bounds)
    two = tround.vote_commit(tc.seed, R, trng.PHASE_VOTE, parts_a[:, :3],
                             fixture["tpack"], parts_a[:, 3] >= tc.quorum,
                             tc.quorum, tc.n_faulty, "reference",
                             fault_model, True, coin_mode=coin_mode,
                             shared=shared, **bounds)
    assert torch.equal(parts_a, tout[1])
    assert torch.equal(two[0], tout[0])
    assert torch.equal(two[1], tout[2])


def test_amnesia_resets_only_undecided_rejoiners(fixture):
    """Amnesia against durable on the same launch: the x planes differ
    exactly where an undecided faulty lane rejoins this round (and an
    inactive one stores "?")."""
    tc = _cfgs("crash_recover", "durable")[1]
    _, (tcr, trcv) = _bounds(fixture, "crash_recover")
    qok = torch.zeros(T, dtype=torch.bool)          # no lane is active
    outs = [tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, torch.from_numpy(fixture["hist2"]),
        fixture["tpack"], qok, tc.quorum, tc.n_faulty, "reference",
        "crash_recover", True, crash_round=tcr, recover_round=trcv,
        rejoin=rj)[0] for rj in ("durable", "amnesia")]
    x_d, x_a = (tround.plane_field(p, PACK_X, 2) for p in outs)
    fau = tround.plane_field(fixture["tpack"], tround.PACK_FAULTY, 1) == 1
    dec = tround.plane_field(fixture["tpack"], tround.PACK_DECIDED, 1) == 1
    rj = fau & (tcr > 0) & (trcv == R) & ~dec
    assert bool(((x_a != x_d) <= rj).all())
    assert bool((x_a[rj] == bt.VALQ).all())
    assert bool((x_a != x_d).any())


# --- the loops -----------------------------------------------------------

LN, LT = 96, 8
F = 40
CRASH = [3] * F + [0] * (LN - F)


def _loop_kw(**kw):
    base = dict(n_nodes=LN, n_faulty=F, trials=LT, delivery="quorum",
                scheduler="uniform", path="histogram", use_pallas_hist=True,
                use_pallas_round=True, max_rounds=24, seed=2)
    base.update(kw)
    return base


def _port_faults(cfg):
    if cfg.fault_model == "crash_recover":
        return trec.crash_recover_faults(cfg)
    return TFaults.first_f(cfg, crash_rounds=CRASH)


def _port_run(kw, use_round=True):
    cfg = bt.SimConfig(**{**kw, "use_pallas_round": use_round})
    return bt.simulate(cfg, balanced_inputs(LT, LN), faults=_port_faults(cfg),
                       device="cpu")


def _fields(st):
    return {k: getattr(st, k).numpy() for k in FIELDS}


@pytest.mark.parametrize("kw,min_rounds", [
    (dict(fault_model="crash_recover", recovery="at:2:4"), 6),
    (dict(fault_model="crash_recover", recovery="at:2:4:amnesia"), 6),
    (dict(fault_model="crash_at_round"), 3),
], ids=["at2_4", "at2_4_amnesia", "crash_at_round"])
def test_loops_match_jax(cf_regime, kw, min_rounds):
    """The JAX package's packed run against the port's packed AND unfused
    runs (the JAX package pins its own packed == unfused identity)."""
    kw = _loop_kw(**kw)
    jc = JCfg(**kw)
    jf = (jrec.crash_recover_faults(jc) if jc.fault_model == "crash_recover"
          else JFaults.first_f(jc, crash_rounds=CRASH))
    jr, jst, _ = jsim.simulate(jc, balanced_inputs(LT, LN), faults=jf)
    for use_round in (True, False):
        tr, tst, _ = _port_run(kw, use_round)
        assert tr == int(jr) >= min_rounds
        for k, v in _fields(tst).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(jst, k)),
                                          err_msg=f"{k} {use_round}")


def test_never_rejoining_equals_crash_at_round(cf_regime):
    """'at:3:0' (down for good from round 3) is crash_at_round at round 3,
    on both loops."""
    for use_round in (True, False):
        a = _port_run(_loop_kw(fault_model="crash_recover",
                               recovery="at:3:0"), use_round)
        b = _port_run(_loop_kw(fault_model="crash_at_round"), use_round)
        assert a[0] == b[0] >= 3
        for k, v in _fields(a[1]).items():
            np.testing.assert_array_equal(v, _fields(b[1])[k], err_msg=k)
        assert a[1].killed.sum() > 0


@pytest.mark.parametrize("use_round", [True, False],
                         ids=["packed", "unfused"])
def test_stagger_slices_match_one_shot(cf_regime, use_round):
    """Liveness comes from the round bounds, not the loop's history: a run
    in slices of 2 rounds equals the one-shot run."""
    cfg = bt.SimConfig(**_loop_kw(fault_model="crash_recover",
                                  recovery="stagger:2:4:amnesia",
                                  use_pallas_round=use_round))
    faults = trec.crash_recover_faults(cfg)
    state0 = bt.init_state(cfg, balanced_inputs(LT, LN), faults)
    rounds, final = bt.run_consensus(cfg, state0, faults)
    assert rounds >= 6
    r, st = 1, tsim.start_state(cfg, state0)
    while True:
        nxt, st = tsim.run_consensus_slice(cfg, st, faults, r, r + 2)
        if nxt == r:
            break
        r = nxt
    assert r - 1 == rounds
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(final, k)), k


def test_dense_crash_recover_matches_jax():
    kw = dict(n_nodes=LN, n_faulty=30, trials=4, delivery="quorum",
              path="dense", use_pallas=True, max_rounds=24, seed=5,
              fault_model="crash_recover", recovery="at:1:3:amnesia")
    jc, tc = JCfg(**kw), bt.SimConfig(**kw)
    assert tc.resolved_path == "dense" and not ttally.pallas_round_active(tc)
    vals = balanced_inputs(4, LN)
    jr, jst, _ = jsim.simulate(jc, vals, faults=jrec.crash_recover_faults(jc))
    tr, tst, _ = bt.simulate(tc, vals, faults=trec.crash_recover_faults(tc),
                             device="cpu")
    assert tr == int(jr) >= 4
    for k, v in _fields(tst).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jst, k)),
                                      err_msg=k)


# --- the C interface -----------------------------------------------------


@pytest.mark.parametrize("entry", [
    "benor_round_blocks", "benor_proposal_hist", "benor_vote_commit",
    "benor_fused_fits", "benor_fused_round"])
def test_round_entry_points_match_their_signatures(entry):
    """ctypes passes exactly the arguments the C entry declares (the round
    bounds' operands and modes included)."""
    from benor_tpu_torch.ops import _build
    src = (_build.CSRC / "round_kernels.cu").read_text()
    decl = src.split(f'extern "C" int {entry}(')[1].split(")")[0]
    assert len(_build.SIGNATURES[entry]) == decl.count(",") + 1
    assert (_build.CSRC / "round_b2.cu") in _build.sources()
