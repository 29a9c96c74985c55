"""The packed round's counts modes, coins and equivocation: the port's
three round kernels (their plain versions, which the wrappers run on CPU
tensors) against the JAX package's Pallas kernels in interpret mode, case
by case — sampled counts with equivocators' mixed-population draws,
sampled counts under the common and weak-common coins, the adversarial
scheduler's delivered counts and the targeted adversary's camps under each
coin, delivered counts with equivocators — on the same pack, counts and
keys: summed partials and new plane stacks exactly equal; inside the port
the fused round equal to proposal + sum + vote.  Then bench.py's nine
flagship regimes that run the round kernels with these branches
(bench.py:337-406), at N = 1000: the port's packed loop against the JAX
package's ``use_pallas_round=True`` run, rounds, x, decided and k exactly
equal; the packed loop against the unfused loop exactly where the JAX
package's are (the common coin under both adversaries, sampled
equivocation with the private coin), elsewhere on the coin-free fields and
the regime's verdict; and runs in slices and resumed runs against the
one-shot run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu import state as jstate
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import pallas_round as jround
from benor_tpu.ops import rng as jrng
from benor_tpu.ops import sampling as jsampling
from benor_tpu.ops import tally as jtally
from benor_tpu.ops.collectives import SINGLE
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import convert
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.state import PACK_COINED
from benor_tpu_torch.sweep import balanced_inputs
from torch_ref_pool import prefetch, ref, start

R = 3
EPS = 0.5

# (trials, nodes, fault_model, counts_mode, coin_mode, rule, freeze):
# N = 1024 is two full tiles, N = 1000 two tiles with pad lanes
CASES = [
    (3, 1000, "equivocate", "sampled", "private", "reference", True),
    (2, 1024, "crash", "sampled", "common", "reference", False),
    (3, 1000, "byzantine", "sampled", "weak_common", "textbook", True),
    (2, 1000, "crash", "delivered", "private", "reference", True),
    (3, 1024, "byzantine", "delivered", "common", "textbook", False),
    (2, 1000, "crash", "delivered", "weak_common", "reference", False),
    (3, 1000, "equivocate", "delivered", "common", "reference", True),
    (3, 1000, "crash", "camps", "private", "reference", True),
    (2, 1024, "crash", "camps", "common", "textbook", False),
    (2, 1000, "equivocate", "camps", "weak_common", "reference", True),
]
IDS = [f"{c[3]}-{c[4]}-{c[2]}" for c in CASES]
# the fused kernel serves sampled counts: its cases, and equivocation under
# the weak coin (held against the pair inside the port)
FUSED_CASES = [c for c in CASES if c[3] == "sampled"] + [
    (2, 1000, "equivocate", "sampled", "weak_common", "textbook", False)]
SCHEDULER = {"sampled": "uniform", "delivered": "adversarial",
             "camps": "targeted"}

# the JAX side's set-up runs op by op: each op compiles once a shape and
# is shared by every case, where a jit would compile once a config


def _jax_pack(cfg, st, faulty):
    return jround.pack_state(cfg, st, faulty)


def _jax_hist(cfg, pack):
    return jround.sent_hist_from_pack(cfg, pack, None, None, R, SINGLE)


def _jax_n_equiv(cfg, pack):
    return jround.n_equiv_from_pack(cfg, pack, SINGLE)


def _jax_adversarial(hist, m, n_free):
    return jtally.adversarial_counts(jnp.asarray(hist), m, n_free)


def _jax_triples(cfg, h, nf):
    return jtally.targeted_camp_triples(cfg, jnp.asarray(h), n_free=nf)


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


def _draws(t, n, seed):
    """The case's random mid-run state, faulty lanes, vote histogram and
    shared coins, drawn in one order for both packages."""
    rs = np.random.default_rng(seed)
    leaves = dict(x=rs.integers(0, 3, size=(t, n)).astype(np.int8),
                  decided=rs.random((t, n)) < 0.2,
                  k=rs.integers(0, 14, size=(t, n)).astype(np.int32),
                  killed=rs.random((t, n)) < 0.15)
    faulty = rs.random((t, n)) < 0.25
    hist2 = rs.integers(0, n // 2, size=(t, 3)).astype(np.int32)
    shared = rs.integers(0, 2, size=t).astype(np.int32)
    return leaves, faulty, hist2, shared


def _case_kw(t, n, fault_model, counts_mode, seed):
    return dict(n_nodes=n, n_faulty=int(0.4 * n), trials=t, max_rounds=12,
                fault_model=fault_model, seed=seed, delivery="quorum",
                scheduler=SCHEDULER[counts_mode])


def _jax_setup(t, n, fault_model, counts_mode, seed):
    """The JAX side of ``_setup``: its config, pack, (honest) proposal
    histogram and live equivocators."""
    jc = JCfg(**_case_kw(t, n, fault_model, counts_mode, seed))
    leaves, faulty, _, _ = _draws(t, n, seed)
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jpack = _jax_pack(jc, jst, jnp.asarray(faulty))
    return jc, jpack, _jax_hist(jc, jpack), _jax_n_equiv(jc, jpack)


def _jax_setup_out(t, n, fault_model, counts_mode, seed):
    """``_jax_setup``'s histogram and live equivocators (a worker's
    call, see torch_ref_pool)."""
    _, _, jhist, jne = _jax_setup(t, n, fault_model, counts_mode, seed)
    return np.asarray(jhist), None if jne is None else np.asarray(jne)


def _setup(t, n, fault_model, counts_mode, seed):
    """A random mid-run state packed by the port, its (honest) proposal
    histogram and live equivocators held against the JAX package's, and a
    vote histogram.  F is 0.4 N, so the closed forms tie in many trials
    and lanes take the coin."""
    tc = bt.SimConfig(**_case_kw(t, n, fault_model, counts_mode, seed))
    leaves, faulty, hist2, shared = _draws(t, n, seed)
    tpack = tround.pack_state(tc, convert.state_from_numpy(**leaves),
                              torch.from_numpy(faulty))
    jhist, jne = ref(_jax_setup_out, t, n, fault_model, counts_mode, seed)
    thist = tround.sent_hist_from_pack(tc, tpack)
    np.testing.assert_array_equal(thist.numpy(), jhist)
    tne = tround.n_equiv_from_pack(tc, tpack)
    if fault_model == "equivocate":
        np.testing.assert_array_equal(tne.numpy(), jne)
    else:
        assert tne is None and jne is None
    return dict(tc=tc, tpack=tpack, thist=thist, tne=tne, hist2=hist2,
                shared=shared)


def _jax_counts(jc, hist_np, counts_mode, jne):
    """A phase's counts in counts_mode's layout, from the JAX package's
    closed forms."""
    if counts_mode == "delivered":
        return _jax_adversarial(np.asarray(hist_np), jc.quorum, jne)
    if counts_mode == "camps":
        return _jax_triples(jc, np.asarray(hist_np), jne)
    return jnp.asarray(hist_np)


def _counts(s, hist_np, counts_mode):
    """The same counts from the port's closed forms (numpy in, torch
    tensor out)."""
    tc = s["tc"]
    th = torch.from_numpy(np.array(hist_np))
    if counts_mode == "delivered":
        return ttally.adversarial_counts(th, tc.quorum, n_free=s["tne"])
    if counts_mode == "camps":
        return ttally.targeted_camp_triples(tc, th, n_free=s["tne"])
    return th


def _jax_camp_bounds(jc, counts_mode):
    if counts_mode != "camps":
        return 0, 0
    s0 = jtally.targeted_camp_sizes(jc)[0]
    return max(jc.n_nodes - 2 * s0, 0), max(jc.n_nodes - s0, 0)


def _pair_seed(t, n):
    return 40 + t + n % 7


def _jax_pair(t, n, fault_model, counts_mode, coin_mode, rule, freeze):
    """The JAX package's proposal and vote kernels in interpret mode on the
    case's pack (a worker's call, see torch_ref_pool)."""
    jc, jpack, jhist, jne = _jax_setup(t, n, fault_model, counts_mode,
                                       _pair_seed(t, n))
    _, _, hist2, shared = _draws(t, n, _pair_seed(t, n))
    b0, b1 = _jax_camp_bounds(jc, counts_mode)
    key = jax.random.key(jc.seed)
    jparts = jround.proposal_hist_pallas(
        key, R, jrng.PHASE_PROPOSAL,
        _jax_counts(jc, np.asarray(jhist), counts_mode, jne), jpack, None,
        jc.quorum, fault_model, freeze, interpret=True, n_equiv=jne,
        counts_mode=counts_mode, camp_b0=b0, camp_b1=b1)
    qok = np.arange(t) % 3 != 2
    jpack2, jvparts = jround.vote_commit_pallas(
        key, R, jrng.PHASE_VOTE, _jax_counts(jc, hist2, counts_mode, jne),
        jpack, None, jnp.asarray(qok), jnp.asarray(shared), jc.quorum,
        jc.n_faulty, rule, coin_mode,
        EPS if coin_mode == "weak_common" else 0.0, freeze, fault_model,
        interpret=True, n_equiv=jne, counts_mode=counts_mode, camp_b0=b0,
        camp_b1=b1)
    return dict(bounds=(b0, b1), parts=np.asarray(jparts),
                pack2=np.asarray(jpack2), vparts=np.asarray(jvparts))


@pytest.mark.parametrize("t,n,fault_model,counts_mode,coin_mode,rule,freeze",
                         CASES, ids=IDS)
@prefetch(lambda t, n, fault_model, counts_mode, coin_mode, rule, freeze: [
    (_jax_setup_out, t, n, fault_model, counts_mode, _pair_seed(t, n)),
    (_jax_pair, t, n, fault_model, counts_mode, coin_mode, rule, freeze)])
def test_pair_matches_pallas(t, n, fault_model, counts_mode, coin_mode, rule,
                             freeze):
    s = _setup(t, n, fault_model, counts_mode, _pair_seed(t, n))
    tc = s["tc"]
    j = ref(_jax_pair, t, n, fault_model, counts_mode, coin_mode, rule,
            freeze)
    b0, b1 = (ttally.targeted_camp_bounds(tc) if counts_mode == "camps"
              else (0, 0))
    assert (b0, b1) == j["bounds"]
    tc1 = _counts(s, s["thist"].numpy(), counts_mode)
    tparts = tround.proposal_hist(
        tc.seed, R, trng.PHASE_PROPOSAL, tc1, s["tpack"], tc.quorum,
        fault_model, freeze, n_equiv=s["tne"], counts_mode=counts_mode,
        camp_b0=b0, camp_b1=b1)
    np.testing.assert_array_equal(tparts.numpy(),
                                  j["parts"][:, :tround.PROP_COLS])

    qok = np.arange(t) % 3 != 2
    tc2 = _counts(s, s["hist2"], counts_mode)
    tpack2, tvparts = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, tc2, s["tpack"], torch.from_numpy(qok),
        tc.quorum, tc.n_faulty, rule, fault_model, freeze, n_equiv=s["tne"],
        counts_mode=counts_mode, camp_b0=b0, camp_b1=b1, coin_mode=coin_mode,
        eps=EPS if coin_mode == "weak_common" else 0.0,
        shared=torch.from_numpy(s["shared"]))
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2), j["pack2"])
    np.testing.assert_array_equal(tvparts.numpy(),
                                  j["vparts"][:, :tround.VOTE_COLS])
    if coin_mode != "private":
        # the case reaches the shared coin's branch
        assert int(tpack2[:, PACK_COINED].ne(0).sum()) > 0


def _fused_seed(t, n):
    return 60 + t + n % 7


def _jax_fused(t, n, fault_model, counts_mode, coin_mode, rule, freeze):
    """The JAX package's fused kernel in interpret mode on the case's pack
    (a worker's call, see torch_ref_pool)."""
    jc, jpack, jhist, jne = _jax_setup(t, n, fault_model, counts_mode,
                                       _fused_seed(t, n))
    _, _, _, shared = _draws(t, n, _fused_seed(t, n))
    eps = EPS if coin_mode == "weak_common" else 0.0
    jout = jround.fused_round_pallas(
        jax.random.key(jc.seed), R, jhist, jpack, None, jnp.asarray(shared),
        jc.quorum, jc.n_faulty, rule, coin_mode, eps, freeze, fault_model,
        interpret=True, n_equiv=jne)
    return [np.asarray(o) for o in jout[:3]]


@pytest.mark.parametrize("t,n,fault_model,counts_mode,coin_mode,rule,freeze",
                         FUSED_CASES,
                         ids=[f"{c[4]}-{c[2]}" for c in FUSED_CASES])
@prefetch(lambda t, n, fault_model, counts_mode, coin_mode, rule, freeze: [
    (_jax_setup_out, t, n, fault_model, counts_mode, _fused_seed(t, n)),
    (_jax_fused, t, n, fault_model, counts_mode, coin_mode, rule, freeze)])
def test_fused_matches_pallas_and_two_kernel(t, n, fault_model, counts_mode,
                                            coin_mode, rule, freeze):
    s = _setup(t, n, fault_model, counts_mode, _fused_seed(t, n))
    tc = s["tc"]
    eps = EPS if coin_mode == "weak_common" else 0.0
    jout = ref(_jax_fused, t, n, fault_model, counts_mode, coin_mode, rule,
               freeze)
    shared = torch.from_numpy(s["shared"])
    modes = dict(n_equiv=s["tne"], coin_mode=coin_mode, eps=eps,
                 shared=shared)
    tpack2, ta, tb = tround.fused_round(tc.seed, R, s["thist"], s["tpack"],
                                        tc.quorum, tc.n_faulty, rule,
                                        fault_model, freeze, **modes)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2), jout[0])
    np.testing.assert_array_equal(ta.numpy(),
                                  jout[1][:, :tround.PROP_COLS])
    np.testing.assert_array_equal(tb.numpy(),
                                  jout[2][:, :tround.VOTE_COLS])

    # inside the port: fused == proposal + sum + vote, bit for bit
    parts_a = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL,
                                   s["thist"], s["tpack"], tc.quorum,
                                   fault_model, freeze, n_equiv=s["tne"])
    two_pack, two_b = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, parts_a[:, :3], s["tpack"],
        parts_a[:, 3] >= tc.quorum, tc.quorum, tc.n_faulty, rule,
        fault_model, freeze, **modes)
    assert torch.equal(parts_a, ta)
    assert torch.equal(two_pack, tpack2)
    assert torch.equal(two_b, tb)


@prefetch(lambda: [(_jax_setup_out, 2, 1000, "equivocate", "sampled", 5)])
def test_wrappers_refuse_missing_operands():
    s = _setup(2, 1000, "equivocate", "sampled", 5)
    tc, tpack = s["tc"], s["tpack"]
    with pytest.raises(ValueError, match="n_equiv"):
        tround.proposal_hist(tc.seed, R, 0, s["thist"], tpack, tc.quorum,
                             "equivocate", True)
    with pytest.raises(ValueError, match="shared"):
        tround.fused_round(tc.seed, R, s["thist"], tpack, tc.quorum,
                           tc.n_faulty, "reference", "equivocate", True,
                           n_equiv=s["tne"], coin_mode="common")
    with pytest.raises(ValueError, match="eps"):
        tround.vote_commit(tc.seed, R, 1, s["thist"], tpack,
                           torch.ones(2, dtype=torch.bool), tc.quorum,
                           tc.n_faulty, "reference", "crash", True,
                           coin_mode="weak_common", eps=1.0,
                           shared=torch.zeros(2, dtype=torch.int32))


# bench.py:_regimes' nine regimes that run the round kernels' new branches
# (bench.py:337-406), at N = 1000: (name, overrides, equivocators alive)
N, T, MAX_ROUNDS = 1000, 2, 64


def _even(f):
    return f + (N - f) % 2


F_SUB = N // 3 - (1 if N % 3 == 0 else 0)
REGIMES = [
    ("adv_private", dict(scheduler="adversarial", coin_mode="private",
                         n_faulty=_even(int(0.2 * N)), max_rounds=12), False),
    ("adv_common", dict(scheduler="adversarial", coin_mode="common",
                        n_faulty=_even(int(0.2 * N))), False),
    ("weak_eps0.55", dict(scheduler="adversarial", coin_mode="weak_common",
                          coin_eps=0.55, n_faulty=_even(int(0.4 * N)),
                          max_rounds=12), False),
    ("weak_eps0.65", dict(scheduler="adversarial", coin_mode="weak_common",
                          coin_eps=0.65, n_faulty=_even(int(0.4 * N)),
                          max_rounds=12), False),
    ("targeted_f0.25", dict(scheduler="targeted",
                            n_faulty=_even(int(0.25 * N)), max_rounds=16,
                            use_pallas_hist=False), False),
    ("targeted_f0.50", dict(scheduler="targeted", n_faulty=N // 2 + 1,
                            max_rounds=12, use_pallas_hist=False), False),
    ("equiv_3f_sub", dict(scheduler="adversarial", coin_mode="common",
                          fault_model="equivocate", n_faulty=F_SUB,
                          use_pallas_hist=False), True),
    ("equiv_3f_super", dict(scheduler="adversarial", coin_mode="common",
                            fault_model="equivocate", n_faulty=N // 3 + 1,
                            max_rounds=12, use_pallas_hist=False), True),
    ("equiv_uniform_f0.20", dict(scheduler="uniform",
                                 fault_model="equivocate",
                                 n_faulty=int(0.2 * N)), True),
]
# where the JAX package's packed and unfused loops agree bit for bit
UNFUSED_EXACT = ("adv_common", "equiv_3f_sub", "equiv_3f_super",
                 "equiv_uniform_f0.20")
# the rest but the weak coin's: their verdicts do not hang on the coin
COIN_FREE = ("adv_private", "targeted_f0.25", "targeted_f0.50")


def _regime_kw(over, use_round=True):
    kw = dict(n_nodes=N, trials=T, max_rounds=MAX_ROUNDS, delivery="quorum",
              path="histogram", fault_model="crash", seed=0,
              use_pallas_hist=True, use_pallas_round=use_round)
    kw.update(over)
    kw["use_pallas_round"] = use_round
    return kw


def _port_run(over, alive_eq, use_round=True):
    cfg = bt.SimConfig(**_regime_kw(over, use_round))
    faults = (TFaults.first_f(cfg) if alive_eq
              else TFaults.none(T, N))
    return bt.simulate(cfg, balanced_inputs(T, N), faults=faults,
                       device="cpu")


def _fields(st):
    return {k: getattr(st, k).numpy() for k in ("x", "decided", "k",
                                                  "killed")}


def _jax_regime(over, alive_eq):
    """The JAX package's ``use_pallas_round=True`` run in the CF regime
    (EXACT_TABLE_MAX = 4, as ``cf_regime``; a worker's call, see
    torch_ref_pool)."""
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = 4
    try:
        jc = JCfg(**_regime_kw(over))
        faults = (JFaults.first_f(jc) if alive_eq else JFaults.none(T, N))
        jr, jst, _ = jsim.simulate(jc, balanced_inputs(T, N), faults=faults)
        return int(jr), {k: np.asarray(getattr(jst, k))
                         for k in ("x", "decided", "k", "killed")}
    finally:
        jsampling.EXACT_TABLE_MAX = old


@pytest.mark.parametrize("name,over,alive_eq", REGIMES,
                         ids=[r[0] for r in REGIMES])
@prefetch(lambda name, over, alive_eq: [(_jax_regime, over, alive_eq)])
def test_regime_matches_jax_packed(cf_regime, name, over, alive_eq):
    jc = JCfg(**_regime_kw(over))
    tc = bt.SimConfig(**_regime_kw(over))
    assert jtally.pallas_round_active(jc)
    assert ttally.pallas_round_active(tc)
    assert not tround.fused_one_pass_eligible(tc, T, N) or \
        tc.scheduler == "uniform"
    jr, jfields = ref(_jax_regime, over, alive_eq)
    tr, tst, _ = _port_run(over, alive_eq)
    assert tr == jr
    for k, v in _fields(tst).items():
        np.testing.assert_array_equal(v, jfields[k], err_msg=k)
    # the structural outcomes bench.py's regimes are chosen for
    if name in ("targeted_f0.50", "equiv_3f_super", "adv_private",
                "weak_eps0.65"):
        assert not tst.decided.any() and tr == tc.max_rounds
    if name in ("adv_common", "weak_eps0.55", "equiv_3f_sub",
                "equiv_uniform_f0.20"):
        assert tst.decided[~tst.killed].all()


@pytest.mark.parametrize(
    "name,over,alive_eq",
    [r for r in REGIMES if r[0] in UNFUSED_EXACT + COIN_FREE],
    ids=[r[0] for r in REGIMES if r[0] in UNFUSED_EXACT + COIN_FREE])
def test_regime_packed_vs_unfused(cf_regime, name, over, alive_eq):
    """Exactly equal where both loops share every random bit; elsewhere
    the coin streams differ by design (the kernels' threefry coin against
    the unfused ``fold_in`` chain), and the coin-free fields and the
    verdict agree."""
    pr, pst, _ = _port_run(over, alive_eq, use_round=True)
    ur, ust, _ = _port_run(over, alive_eq, use_round=False)
    p, u = _fields(pst), _fields(ust)
    if name in UNFUSED_EXACT:
        assert pr == ur
        for k in p:
            np.testing.assert_array_equal(p[k], u[k], err_msg=k)
        return
    assert pr == ur
    np.testing.assert_array_equal(p["decided"], u["decided"])
    np.testing.assert_array_equal(p["k"], u["k"])
    if name.startswith("targeted"):
        # the camps' values are coin-free; only the "?" camp's x may differ
        b0, _ = ttally.targeted_camp_bounds(
            bt.SimConfig(**_regime_kw(over)))
        np.testing.assert_array_equal(p["x"][:, b0:], u["x"][:, b0:])


@pytest.mark.parametrize("use_round", [True, False],
                         ids=["packed", "unfused"])
def test_weak_coin_transition_on_both_loops(use_round):
    """The weak coin against the count adversary: the termination
    transition at eps* = 1 - f is a law of the delivered counts, not of a
    coin stream, so both loops (whose deviation streams differ) keep it,
    at margins wide enough for N = 1000: f = 0.4, eps 0.3 decides every
    lane, eps 0.95 none."""
    for eps, want in ((0.3, True), (0.95, False)):
        over = dict(scheduler="adversarial", coin_mode="weak_common",
                    coin_eps=eps, n_faulty=_even(int(0.4 * N)),
                    max_rounds=12)
        _, st, _ = _port_run(over, False, use_round)
        assert bool(st.decided.all()) is want
        assert bool(st.decided.any()) is want


@pytest.mark.parametrize("name", ["adv_private", "equiv_3f_super"])
def test_slices_and_resume_match_one_shot(name):
    over, alive_eq = {r[0]: r[1:] for r in REGIMES}[name]
    cfg = bt.SimConfig(**_regime_kw(over))
    faults = TFaults.first_f(cfg) if alive_eq else TFaults.none(T, N)
    state0 = bt.init_state(cfg, balanced_inputs(T, N), faults)
    rounds, final = bt.run_consensus(cfg, state0, faults)
    assert rounds == cfg.max_rounds
    r, st = 1, tsim.start_state(cfg, state0)
    mid = None
    while True:
        nxt, st = tsim.run_consensus_slice(cfg, st, faults, r, r + 5)
        if nxt == r:
            break
        r = nxt
        if mid is None:
            mid = (r, st)
    assert r - 1 == rounds
    rr, rfin = tsim.resume_consensus(cfg, mid[1], faults, mid[0])
    assert rr == rounds
    for k in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(st, k), getattr(final, k)), k
        assert torch.equal(getattr(rfin, k), getattr(final, k)), k
