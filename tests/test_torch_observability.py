"""The flight recorder, the witness recorder and the kernel stage counters
(SimConfig.record / witness_trials / kernel_telemetry) on the port against
the JAX package, on the CPU.

The recorder and witness tables and their row builders on seeded numpy
inputs; the three round kernels' plain versions, armed with the recorder,
16 watched nodes and the counters, against the JAX package's Pallas kernels
in interpret mode, armed alike, on one pack (T = 3, N = 1000: two tiles,
pad lanes) whose round bounds put faulty lanes in every class, under the
crash and crash_recover (amnesia) models and the sampled, delivered and
camps counts; then ``run_consensus`` with all three flags against the JAX
package's on the fused packed path, the two-kernel packed path, the
unfused histogram path, the dense path and ``delivery='all'`` — every
buffer exactly equal, and an armed run's final state equal to the unarmed
one's; runs in slices against the one-shot run; a port witness buffer
audited by the JAX package's auditor, clean, and a forged entry caught;
the renderers and the facade's round history and witness against the JAX
package's.  Each JAX comparison arms all three flags, so a mode compiles
once; the JAX side's caches are dropped when the module is done."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import api as japi
from benor_tpu import audit as jaudit
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
from benor_tpu.utils import metrics as jmetrics
from benor_tpu_torch import api as tapi
from benor_tpu_torch import audit as taudit
from benor_tpu_torch import convert
from benor_tpu_torch import sim as tsim
from benor_tpu_torch import state as tstate
from benor_tpu_torch.faults import recovery as trec
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs
from benor_tpu_torch.utils import metrics as tmetrics
from torch_ref_pool import prefetch, ref, start

FIELDS = ("x", "decided", "k", "killed")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
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


# --- the tables and their row builders -----------------------------------


def test_layouts_match_jax():
    assert tstate.REC_LAYOUT == jstate.REC_LAYOUT
    assert tstate.REC_COLUMNS == jstate.REC_COLUMNS
    assert tstate.WIT_LAYOUT == jstate.WIT_LAYOUT
    assert tstate.WIT_COLUMNS == jstate.WIT_COLUMNS
    for name in ("PROP_PARTIAL_LAYOUT", "VOTE_PARTIAL_LAYOUT",
                 "VOTE_RECORD_LAYOUT", "WITNESS_PROP_FIELDS",
                 "WITNESS_VOTE_FIELDS", "TELEM_COLS", "TELEM_WIDTH",
                 "TELEM_COLUMNS", "TELEM_STAGES"):
        assert getattr(tround, name) == getattr(jround, name), name
    for record in (False, True):
        assert tround._witb_base(record) == jround._witb_base(record)
        for k in (0, 3, 16):
            for stage in tround.TELEM_STAGES:
                assert tround._telem_base(stage, record, k) == \
                    jround._telem_base(stage, record, k)
    for kw in (dict(n_nodes=1000, trials=3), dict(n_nodes=96, trials=8),
               dict(n_nodes=96, trials=8, scheduler="adversarial"),
               dict(n_nodes=9000, trials=40), dict(n_nodes=8192, trials=40)):
        kw.update(n_faulty=kw["n_nodes"] // 4, delivery="quorum")
        args = (kw["trials"], kw["n_nodes"])
        assert tround.telemetry_tiles(bt.SimConfig(**kw), *args) == \
            jround.telemetry_tiles(JCfg(**kw), *args)


@pytest.mark.parametrize("n,k", [(10, 1), (10, 10), (1000, 16), (97, 5)])
def test_witness_node_ids_match_jax(n, k):
    kw = dict(n_nodes=n, n_faulty=0, trials=4, witness_trials=(0, 2),
              witness_nodes=k)
    ids = tstate.witness_node_ids(bt.SimConfig(**kw))
    np.testing.assert_array_equal(ids, jstate.witness_node_ids(JCfg(**kw)))
    lo, hs, kk = tround.watched_ranges(ids)
    assert kk == k and list(ids) == list(range(lo)) + list(
        range(hs, hs + k - lo))


def test_state_rows_match_jax():
    """new_recorder / recorder_round_row / new_witness / witness_round_row on
    seeded fields, and the in-place writes."""
    rs = np.random.default_rng(4)
    t, n = 5, 40
    kw = dict(n_nodes=n, n_faulty=0, trials=t, max_rounds=6,
              witness_trials=(1, 3), witness_nodes=7)
    jc, tc = JCfg(**kw), bt.SimConfig(**kw)
    leaves = dict(x=rs.integers(0, 3, size=(t, n)).astype(np.int8),
                  decided=rs.random((t, n)) < 0.3,
                  k=rs.integers(0, 5, size=(t, n)).astype(np.int32),
                  killed=rs.random((t, n)) < 0.2)
    coined = rs.random((t, n)) < 0.3
    margin = rs.integers(0, 30, size=(t, n)).astype(np.int32)
    tallies = [rs.integers(0, n, size=(t, n)).astype(np.float32)
               for _ in range(4)]
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tst = convert.state_from_numpy(**leaves)
    jrec_, trec_ = jstate.new_recorder(jc, jst), tstate.new_recorder(tc, tst)
    jwit, twit = jstate.new_witness(jc, jst), tstate.new_witness(tc, tst)
    jrow = jstate.recorder_round_row(jst.x, jst.decided, jst.killed,
                                     jnp.asarray(coined),
                                     jnp.asarray(margin))
    trow = tstate.recorder_round_row(tst.x, tst.decided, tst.killed,
                                     torch.from_numpy(coined),
                                     torch.from_numpy(margin))
    jw = jstate.witness_round_row(jc, jst.x, jst.decided, jst.killed,
                                  jnp.asarray(coined),
                                  *map(jnp.asarray, tallies))
    tw = tstate.witness_round_row(tc, tst.x, tst.decided, tst.killed,
                                  torch.from_numpy(coined),
                                  *map(torch.from_numpy, tallies))
    jrec_ = jstate.recorder_write(jrec_, 3, jrow)
    jwit = jstate.witness_write(jwit, 2, jw)
    assert tstate.recorder_write(trec_, 3, trow) is trec_
    assert tstate.witness_write(twit, 2, tw) is twit
    np.testing.assert_array_equal(trec_.numpy(), np.asarray(jrec_))
    np.testing.assert_array_equal(twit.numpy(), np.asarray(jwit))
    assert trec_.dtype == twit.dtype == torch.int32


def test_armed_launch_operands():
    """What an armed launch starts from: the witness outputs zeroed, the
    kernel pointed at the caller's counter accumulator, to which the host
    adds the shape columns (a tile's real and pad lanes, sampler draws,
    plane passes), other counts left for the kernel to add."""
    wids = (0, 1, 2, 997, 998, 999)
    tel = torch.ones((2, 2, tround.TELEM_WIDTH), dtype=torch.int32)
    obs, wa, wb = tround._obs_operands(3, torch.device("cpu"), wids, 1000,
                                       tel)
    assert (obs.lo, obs.hs, obs.k, obs.n_local) == (3, 997, 6, 1000)
    assert wa.shape == (3, 6, 2) and wb.shape == (3, 6, 6)
    assert not wa.any() and not wb.any()
    assert obs.telem == tel.data_ptr()
    tround._add_shape_cols(tel, 3, 1000, 512, False, (1, 2))
    tel -= 1
    col = tround.TELEM_COLS
    assert tel[:, :, col["active_lanes"][0]].tolist() == [[1536, 1464]] * 2
    assert tel[:, :, col["pad_lanes"][0]].tolist() == [[0, 72]] * 2
    assert not tel[:, :, col["sampler_draws"][0]].any()
    assert tel[:, :, col["plane_hops"][0]].tolist() == [[3, 3], [6, 6]]
    for c in ("hist_visits", "quorum_passes", "coin_draws"):
        assert not tel[:, :, col[c][0]].any()
    obs, wa, wb = tround._obs_operands(3, torch.device("cpu"), (), 1000)
    assert obs.k == 0 and wa is wb is None
    assert not obs.wit_a and not obs.telem
    with pytest.raises(ValueError, match="range"):
        tround.watched_ranges((0, 2, 5))


# --- the three kernels' plain versions against the Pallas kernels ---------

R = 3
T, N = 3, 1000
NP = 1024
EPS = 0.5
WIDS = tuple(int(i) for i in range(8)) + tuple(range(N - 8, N))


def _draws():
    """A random mid-run state (0.45 of the lanes faulty), round bounds that
    put faulty lanes in every class at round R (crash rounds in {0, 1..6},
    recover rounds in {0, cr + 1 .. cr + 4}, pad lanes 0), shared coins
    and a vote histogram, as in tests/test_torch_crash_rounds.py."""
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
    shared = rs.integers(0, 2, size=T).astype(np.int32)
    hist2 = rs.integers(0, N // 2, size=(T, 3)).astype(np.int32)
    return leaves, faulty, cr, rcv, shared, hist2


def _jax_fixture():
    """The draws with the state packed by the JAX package."""
    leaves, faulty, cr, rcv, shared, hist2 = _draws()
    jc = JCfg(n_nodes=N, n_faulty=400, trials=T, max_rounds=12)
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jpack = jround.pack_state(jc, jst, jnp.asarray(faulty))
    return dict(jpack=jpack, cr=cr, rcv=rcv, shared=shared, hist2=hist2)


@pytest.fixture(scope="module")
def fixture():
    """The draws with the state packed by the port."""
    leaves, faulty, cr, rcv, shared, hist2 = _draws()
    tpack = tround.pack_state(bt.SimConfig(n_nodes=N, n_faulty=400,
                                           trials=T, max_rounds=12),
                              convert.state_from_numpy(**leaves),
                              torch.from_numpy(faulty))
    return dict(tpack=tpack, cr=cr, rcv=rcv, shared=shared, hist2=hist2)


def _cfgs(fault_model, counts_mode="sampled"):
    sched = {"sampled": "uniform", "delivered": "adversarial",
             "camps": "targeted"}[counts_mode]
    kw = dict(n_nodes=N, n_faulty=400, trials=T, max_rounds=12,
              fault_model=fault_model, delivery="quorum", scheduler=sched,
              recovery=("at:1:4:amnesia" if fault_model == "crash_recover"
                        else None))
    return JCfg(**kw), bt.SimConfig(**kw)


def _bounds(fx, fault_model):
    """The round bounds as JAX arrays or port tensors; none under
    crash."""
    if fault_model == "crash":
        return None, None
    if "jpack" in fx:
        return jnp.asarray(fx["cr"]), jnp.asarray(fx["rcv"])
    return torch.from_numpy(fx["cr"]), torch.from_numpy(fx["rcv"])


def _jax_counts(jc, hist, counts_mode):
    if counts_mode == "delivered":
        return jtally.adversarial_counts(jnp.asarray(hist), jc.quorum)
    if counts_mode == "camps":
        return jtally.targeted_camp_triples(jc, jnp.asarray(hist))
    return jnp.asarray(hist)


def _counts(tc, hist, counts_mode):
    th = torch.from_numpy(np.array(hist))
    if counts_mode == "delivered":
        return ttally.adversarial_counts(th, tc.quorum)
    if counts_mode == "camps":
        return ttally.targeted_camp_triples(tc, th)
    return th


def _camps(tc, counts_mode):
    return (ttally.targeted_camp_bounds(tc) if counts_mode == "camps"
            else (0, 0))


def _rejoin(fault_model):
    return "amnesia" if fault_model == "crash_recover" else "durable"


def _ids(cases):
    return ["-".join(c) for c in cases]


# (fault model, counts mode[, coin])
PROPOSAL_CASES = [("crash", "sampled"), ("crash", "delivered"),
                  ("crash", "camps"), ("crash_recover", "sampled")]
VOTE_CASES = [("crash", "sampled", "private"),
              ("crash", "delivered", "common"),
              ("crash", "camps", "weak_common"),
              ("crash_recover", "sampled", "weak_common")]
# (the crash model's fused round is held on the loop, test_loop_planes_*)
FUSED_CASES = [("crash_recover", "common")]


def _jax_armed_proposal(fault_model, counts_mode):
    """The JAX package's armed proposal kernel in interpret mode, with the
    histogram it is fed (a worker's call, see torch_ref_pool)."""
    jc, _ = _cfgs(fault_model, counts_mode)
    fx = _jax_fixture()
    jcr, jrcv = _bounds(fx, fault_model)
    hist = np.asarray(jround.sent_hist_from_pack(jc, fx["jpack"], jcr,
                                                 jrcv, R, SINGLE))
    b0, b1 = _camps(_cfgs(fault_model, counts_mode)[1], counts_mode)
    jsum, jtel = jround.proposal_hist_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_PROPOSAL,
        _jax_counts(jc, hist, counts_mode), fx["jpack"], jcr, jc.quorum,
        fault_model, True, interpret=True, counts_mode=counts_mode,
        camp_b0=b0, camp_b1=b1, witness_ids=WIDS, n_local=N, telemetry=True,
        recover_round=jrcv, rejoin=_rejoin(fault_model))
    return hist, np.asarray(jsum), np.asarray(jtel)


@pytest.mark.parametrize("fault_model,counts_mode", PROPOSAL_CASES,
                         ids=_ids(PROPOSAL_CASES))
@prefetch(lambda fault_model, counts_mode: [
    (_jax_armed_proposal, fault_model, counts_mode)])
def test_armed_proposal_matches_pallas(fixture, fault_model, counts_mode):
    """The witness fields (p0, p1 of 16 watched lanes) and the proposal
    stage's counters per tile, beside the base columns."""
    _, tc = _cfgs(fault_model, counts_mode)
    tcr, trcv = _bounds(fixture, fault_model)
    rejoin = _rejoin(fault_model)
    hist, jsum, jtel = ref(_jax_armed_proposal, fault_model, counts_mode)
    tcounts = _counts(tc, hist, counts_mode)
    b0, b1 = _camps(tc, counts_mode)
    tel = torch.zeros((NP // 512, 7), dtype=torch.int32)
    got = tround.proposal_hist(
        tc.seed, R, trng.PHASE_PROPOSAL, tcounts, fixture["tpack"],
        tc.quorum, fault_model, True, counts_mode=counts_mode, camp_b0=b0,
        camp_b1=b1, crash_round=tcr, recover_round=trcv, rejoin=rejoin,
        witness_ids=WIDS, n_local=N, telemetry=tel)
    width = tround.PROP_COLS + 2 * len(WIDS)
    assert got.shape == (T, width)
    np.testing.assert_array_equal(got.numpy(), jsum[:, :width])
    np.testing.assert_array_equal(tel.numpy(), jtel)
    assert got[:, tround.PROP_COLS:].any()


def _jax_armed_vote(fault_model, counts_mode, coin_mode):
    """The JAX package's armed vote kernel in interpret mode (a worker's
    call, see torch_ref_pool)."""
    jc, tc = _cfgs(fault_model, counts_mode)
    fx = _jax_fixture()
    jcr, jrcv = _bounds(fx, fault_model)
    b0, b1 = _camps(tc, counts_mode)
    qok = np.arange(T) % 3 != 2
    eps = EPS if coin_mode == "weak_common" else 0.0
    jpack2, jsum, jtel = jround.vote_commit_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_VOTE,
        _jax_counts(jc, fx["hist2"], counts_mode), fx["jpack"], jcr,
        jnp.asarray(qok), jnp.asarray(fx["shared"]), jc.quorum, jc.n_faulty,
        "reference", coin_mode, eps, True, fault_model, interpret=True,
        counts_mode=counts_mode, camp_b0=b0, camp_b1=b1, record=True,
        witness_ids=WIDS, n_local=N, telemetry=True, recover_round=jrcv,
        rejoin=_rejoin(fault_model))
    return np.asarray(jpack2), np.asarray(jsum), np.asarray(jtel)


@pytest.mark.parametrize("fault_model,counts_mode,coin_mode", VOTE_CASES,
                         ids=_ids(VOTE_CASES))
@prefetch(lambda fault_model, counts_mode, coin_mode: [
    (_jax_armed_vote, fault_model, counts_mode, coin_mode)])
def test_armed_vote_matches_pallas(fixture, fault_model, counts_mode,
                                   coin_mode):
    """The recorder's columns (the margin a max over tiles, killed with the
    pad lanes), the witness fields and the vote stage's counters, beside
    the new stack and the base columns; the armed run's stack and base
    columns equal the unarmed run's."""
    _, tc = _cfgs(fault_model, counts_mode)
    tcr, trcv = _bounds(fixture, fault_model)
    rejoin = _rejoin(fault_model)
    tcounts = _counts(tc, fixture["hist2"], counts_mode)
    b0, b1 = _camps(tc, counts_mode)
    qok = np.arange(T) % 3 != 2
    eps = EPS if coin_mode == "weak_common" else 0.0
    jpack2, jsum, jtel = ref(_jax_armed_vote, fault_model, counts_mode,
                             coin_mode)
    args = (tc.seed, R, trng.PHASE_VOTE, tcounts, fixture["tpack"],
            torch.from_numpy(qok), tc.quorum, tc.n_faulty, "reference",
            fault_model, True)
    kw = dict(counts_mode=counts_mode, camp_b0=b0, camp_b1=b1,
              coin_mode=coin_mode, eps=eps,
              shared=torch.from_numpy(fixture["shared"]), crash_round=tcr,
              recover_round=trcv, rejoin=rejoin)
    tel = torch.zeros((NP // 512, 7), dtype=torch.int32)
    tpack2, got = tround.vote_commit(*args, **kw, record=True,
                                     witness_ids=WIDS, n_local=N,
                                     telemetry=tel)
    width = tround.VOTE_OBS_COLS + 6 * len(WIDS)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2), jpack2)
    np.testing.assert_array_equal(got.numpy(), jsum[:, :width])
    np.testing.assert_array_equal(tel.numpy(), jtel)
    plain_pack, plain = tround.vote_commit(*args, **kw)
    assert torch.equal(plain_pack, tpack2)
    assert torch.equal(plain, got[:, :tround.VOTE_COLS])
    if fault_model == "crash_recover":
        # the down lanes are unsettled and, not latched killed, undecided
        undec = got[:, 7:10].sum(1)
        assert bool((undec + got[:, 5] + got[:, 6] >= NP).all())


def _jax_armed_fused(fault_model, coin_mode):
    """The JAX package's armed fused kernel in interpret mode, with the
    histogram it is fed (a worker's call, see torch_ref_pool)."""
    jc, _ = _cfgs(fault_model)
    fx = _jax_fixture()
    jcr, jrcv = _bounds(fx, fault_model)
    hist = jround.sent_hist_from_pack(jc, fx["jpack"], jcr, jrcv, R, SINGLE)
    jout = jround.fused_round_pallas(
        jax.random.key(jc.seed), R, hist, fx["jpack"], jcr,
        jnp.asarray(fx["shared"]), jc.quorum, jc.n_faulty, "textbook",
        coin_mode, 0.0, True, fault_model, interpret=True, record=True,
        witness_ids=WIDS, n_local=N, telemetry=True, recover_round=jrcv,
        rejoin=_rejoin(fault_model))
    return np.asarray(hist), [np.asarray(o) for o in jout]


@pytest.mark.parametrize("fault_model,coin_mode", FUSED_CASES,
                         ids=_ids(FUSED_CASES))
@prefetch(lambda fault_model, coin_mode: [
    (_jax_armed_fused, fault_model, coin_mode)])
def test_armed_fused_matches_pallas(fixture, fault_model, coin_mode):
    """The single pass armed: partsA and partsB with their observability
    columns and both stages' counters over one tile; equal to the armed
    two-kernel route on every column both give."""
    _, tc = _cfgs(fault_model)
    tcr, trcv = _bounds(fixture, fault_model)
    rejoin = _rejoin(fault_model)
    hist, jout = ref(_jax_armed_fused, fault_model, coin_mode)
    thist = torch.from_numpy(np.array(hist))
    bounds = dict(crash_round=tcr, recover_round=trcv, rejoin=rejoin)
    shared = torch.from_numpy(fixture["shared"])
    obs = dict(witness_ids=WIDS, n_local=N)
    tel = torch.zeros((2, 1, 7), dtype=torch.int32)
    tout = tround.fused_round(tc.seed, R, thist, fixture["tpack"], tc.quorum,
                              tc.n_faulty, "textbook", fault_model, True,
                              coin_mode=coin_mode, shared=shared, **bounds,
                              record=True, telemetry=tel, **obs)
    assert len(tout) == 3
    wa, wb = tround.PROP_COLS + 2 * 16, tround.VOTE_OBS_COLS + 6 * 16
    np.testing.assert_array_equal(convert.pack_to_numpy(tout[0]), jout[0])
    np.testing.assert_array_equal(tout[1].numpy(), jout[1][:, :wa])
    np.testing.assert_array_equal(tout[2].numpy(), jout[2][:, :wb])
    for i in (0, 1):
        np.testing.assert_array_equal(tel[i].numpy(), jout[3 + i])
    parts_a = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL, thist,
                                   fixture["tpack"], tc.quorum, fault_model,
                                   True, **bounds, **obs)
    two = tround.vote_commit(tc.seed, R, trng.PHASE_VOTE, parts_a[:, :3],
                             fixture["tpack"], parts_a[:, 3] >= tc.quorum,
                             tc.quorum, tc.n_faulty, "textbook", fault_model,
                             True, coin_mode=coin_mode, shared=shared,
                             **bounds, record=True, **obs)
    assert torch.equal(parts_a, tout[1])
    assert torch.equal(two[0], tout[0])
    assert torch.equal(two[1], tout[2])


# --- the loops -----------------------------------------------------------

LN, LT = 96, 8
OBS = dict(record=True, witness_trials=(0, 3, 5), witness_nodes=6,
           kernel_telemetry=True)

# (config overrides, crash rounds of the first F lanes or None, packed):
# the fused packed path, the two-kernel packed path (the adversarial
# scheduler never fuses) under crash_recover's amnesia rejoin, the unfused
# histogram path under crash_at_round, the dense path, delivery='all'
LOOPS = {
    "fused": (dict(n_faulty=40), None, True),
    "two_kernel": (dict(n_faulty=40, scheduler="adversarial",
                        coin_mode="common", fault_model="crash_recover",
                        recovery="at:2:3:amnesia", max_rounds=10), None,
                   True),
    "unfused": (dict(n_faulty=40, use_pallas_round=False,
                     fault_model="crash_at_round"), [2] * 40 + [0] * 56,
                False),
    "dense": (dict(n_faulty=40, path="dense", use_pallas=True,
                   fault_model="byzantine"), None, False),
    "all": (dict(n_faulty=30, delivery="all"), None, False),
}


def _loop_kw(over):
    base = dict(n_nodes=LN, trials=LT, delivery="quorum", scheduler="uniform",
                path="histogram", use_pallas_hist=True, use_pallas_round=True,
                max_rounds=16, seed=2)
    base.update(over)
    return base


def _faults(pkg, cfg, crash):
    if cfg.fault_model == "crash_recover":
        mod = jrec if pkg == "jax" else trec
        return mod.crash_recover_faults(cfg)
    spec = JFaults if pkg == "jax" else TFaults
    if crash is not None:
        return spec.first_f(cfg, crash_rounds=crash)
    if cfg.fault_model in ("crash", "byzantine"):
        return spec.first_f(cfg)
    return spec.none(LT, LN)


def _port_run(name, **extra):
    over, crash, _ = LOOPS[name]
    cfg = bt.SimConfig(**_loop_kw({**over, **extra}))
    faults = _faults("port", cfg, crash)
    state = bt.init_state(cfg, balanced_inputs(LT, LN), faults)
    return cfg, faults, state, bt.run_consensus(cfg, state, faults)


def _jax_loop(name):
    """The JAX package's run_consensus with the three flags armed, in the
    CF regime (EXACT_TABLE_MAX = 4, as ``cf_regime``; a worker's call, see
    torch_ref_pool)."""
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = 4
    try:
        over, crash, _ = LOOPS[name]
        jc = JCfg(**_loop_kw({**over, **OBS}))
        jf = _faults("jax", jc, crash)
        jout = jsim.run_consensus(jc, jstate.init_state(
            jc, balanced_inputs(LT, LN), jf), jf, jax.random.key(jc.seed))
        return (int(jout[0]), {k: np.asarray(getattr(jout[1], k))
                               for k in FIELDS},
                [np.asarray(o) for o in jout[2:]])
    finally:
        jsampling.EXACT_TABLE_MAX = old


@pytest.mark.parametrize("name", list(LOOPS))
@prefetch(lambda name: [(_jax_loop, name)])
def test_loop_planes_match_jax(cf_regime, name):
    """run_consensus with the recorder, the witness and the counters: the
    rounds, the final state and every buffer equal the JAX package's (the
    counters ride the packed loop only); the armed run's final state equals
    the port's unarmed run's."""
    _, _, packed = LOOPS[name]
    jr, jfields, jtails = ref(_jax_loop, name)
    jout = (jr, jfields, *jtails)
    tc, _, _, tout = _port_run(name, **OBS)
    assert ttally.pallas_round_active(tc) == packed
    assert len(tout) == len(jout) == (5 if packed else 4)
    assert tout[0] == jout[0] >= 2
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tout[1], k).numpy(),
                                      jout[1][k], err_msg=k)
    for i in range(2, len(jout)):
        np.testing.assert_array_equal(tout[i].numpy(), jout[i],
                                      err_msg=f"tail {i}")
    _, _, _, plain = _port_run(name)
    assert plain[0] == tout[0]
    for k in FIELDS:
        assert torch.equal(getattr(plain[1], k), getattr(tout[1], k)), k


@pytest.mark.parametrize("name", ["fused", "two_kernel", "unfused"])
def test_slices_match_one_shot(cf_regime, name):
    """The recorder and the witness carried from slice to slice equal the
    one-shot run's; the packed loop's per-slice counters add up to the
    one-shot run's; a resume from a checkpoint continues the buffers."""
    tc, faults, state0, one = _port_run(name, **OBS)
    packed = ttally.pallas_round_active(tc)
    r, st, rec, wit = 1, tsim.start_state(tc, state0), None, None
    tel = torch.zeros_like(one[4]) if packed else None
    while True:
        out = tsim.run_consensus_slice(tc, st, faults, r, r + 2, rec, wit)
        if out[0] == r:
            break
        r, st, rec, wit = out[:4]
        if packed:
            tel += out[4]
    assert r - 1 == one[0]
    assert torch.equal(rec, one[2]) and torch.equal(wit, one[3])
    if packed:
        assert torch.equal(tel, one[4])
    # resume at round 3 from the one-shot run's state after round 2
    first = tsim.run_consensus_slice(tc, tsim.start_state(tc, state0),
                                     faults, 1, 3)
    rounds, fin, rec2, wit2 = tsim.resume_consensus(tc, first[1], faults, 3,
                                                    first[2], first[3])[:4]
    assert rounds == one[0]
    assert torch.equal(rec2, one[2]) and torch.equal(wit2, one[3])
    # a fresh buffer: row 0 snapshots the re-entry state, rows 1-2 are gaps
    fresh = tsim.resume_consensus(tc, first[1], faults, 3)[2]
    assert not fresh[1:3].any()
    assert torch.equal(fresh[3:], one[2][3:])
    assert [r_["round"] for r_ in tmetrics.round_history_rows(fresh)] == \
        [0] + list(range(3, one[0] + 1))


# --- interop with the JAX package's auditor and renderers ------------------


def test_port_witness_audits_clean_and_forgery_is_caught(cf_regime):
    """A port witness buffer, bundled as the JAX package's WitnessBundle,
    audits clean; a forged decision (x = 1 decided on too few votes) is
    pinpointed at its trial, round and node."""
    tc, faults, _, out = _port_run("fused", **OBS)
    jc = JCfg(**_loop_kw({**LOOPS["fused"][0], **OBS}))
    wit = out[3].numpy()
    report = jaudit.audit_witness(jaudit.WitnessBundle.from_run(
        jc, wit, faults=None, label="port"))
    assert report.ok, report.violations
    forged = wit.copy()
    r, wi, ki = 1, 1, 2
    forged[r, wi, ki, tstate.WIT_X] = 1
    forged[r, wi, ki, tstate.WIT_DECIDED] = 1
    forged[r, wi, ki, tstate.WIT_V1] = 0
    bad = jaudit.audit_witness(jaudit.WitnessBundle.from_run(jc, forged))
    assert not bad.ok
    node = int(tstate.witness_node_ids(tc)[ki])
    hits = [v for v in bad.violations if v.invariant == "quorum_evidence"]
    assert any(v.trial == jc.witness_trials[wi] and v.round == r
               and node in v.nodes for v in hits), bad.violations


def test_renderers_match_jax(cf_regime):
    """round_history_rows (with a cursor), round_history_summary and
    witness_rows on a port buffer equal the JAX package's on the same
    buffer."""
    tc, _, _, out = _port_run("two_kernel", **OBS)
    rec, wit = out[2].numpy(), out[3].numpy()
    for since in (None, 0, 2, 99):
        assert tmetrics.round_history_rows(out[2], since) == \
            jmetrics.round_history_rows(rec, since)
    assert tmetrics.round_history_summary(out[2]) == \
        jmetrics.round_history_summary(rec)
    ids = tstate.witness_node_ids(tc)
    assert taudit.witness_rows(out[3], tc.witness_trials, ids) == \
        jaudit.witness_rows(wit, tc.witness_trials, ids)


_FACADE = dict(n=10, f=4, values=[0, 0, 1, 1, 1, 0, 0, 1, 1, 1],
               faulty=[True] * 4 + [False] * 6,
               kw=dict(poll_rounds=2, record=True, witness_trials=(0,),
                       witness_nodes=4, max_rounds=12))


def _facade(api):
    net = api.launch_network(_FACADE["n"], _FACADE["f"], _FACADE["values"],
                             _FACADE["faulty"], **_FACADE["kw"],
                             **({"device": "cpu"} if api is tapi else {}))
    net.start()
    return (net.rounds_executed,
            [net.get_round_history(since) for since in (None, 1)],
            net.get_witness())


def _jax_facade():
    """The JAX facade's answers (a worker's call, see torch_ref_pool)."""
    return _facade(japi)


@prefetch(lambda: [(_jax_facade,)])
def test_facade_history_and_witness_match_jax():
    """get_round_history(since_round) and get_witness through
    launch_network with poll_rounds equal the JAX facade's."""
    j_rounds, j_hist, j_wit = ref(_jax_facade)
    t_rounds, t_hist, t_wit = _facade(tapi)
    assert t_rounds == j_rounds >= 1
    for t_h, j_h in zip(t_hist, j_hist):
        assert t_h == j_h
    assert t_wit == j_wit
