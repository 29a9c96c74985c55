"""The structured delivery planes of benor_tpu_torch against the JAX
package, on the CPU: the topology grammar and its verdicts, the neighbour
tables and ids, the neighbourhood tally, the committee draw and tally,
whole ``simulate`` runs (final state, recorder, witness), the per-lane
gate bar under a topology and a partition, the ``'complete'`` identity,
the port's witness audited by the JAX package's auditor with the d + 1
bound, and the facade.

Sizes are bench.py's topo check: N = 64 (``torus2d:8x8``), T = 8,
``max_rounds`` 24.  Every comparison is exact.  Each whole-run mode arms
the recorder and the witness at once (one JAX executable a mode, shared
through a module-scoped fixture); the table and tally comparisons call
the JAX functions op by op, outside ``jax.jit``; the JAX side's caches are
dropped when the module is done."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import audit as jaudit
from benor_tpu import sim as jsim
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import rng as jrng
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu.topo import committees as jcom
from benor_tpu.topo import deliver as jdeliver
from benor_tpu.topo import graphs as jgraphs
from benor_tpu.utils import tracing as jtracing
from benor_tpu_torch import state as tstate
from benor_tpu_torch.models import benor as tbenor
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import hist as thist
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import random_inputs
from benor_tpu_torch.topo import committees as tcom
from benor_tpu_torch.topo import deliver as tdeliver
from benor_tpu_torch.topo import graphs as tgraphs
from benor_tpu_torch.utils import tracing as ttracing
from torch_ref_pool import prefetch, ref, start

FIELDS = ("x", "decided", "k", "killed")
N, T, SEED = 64, 8, 5
OBS = dict(record=True, witness_trials=(0, 3), witness_nodes=6)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


# --- the grammar ----------------------------------------------------------

SPECS = ["ring:4", "ring:3", "ring:0", "ring:64", "ring", "ring:4:5",
         "torus2d:8x8", "torus2d:2x32", "torus2d:4x4", "torus2d:8-8",
         "expander:6", "expander:12", "expander:14", "random_regular:6:1",
         "random_regular:6", "random_regular:40", "random_regular:x",
         "mesh:4", 123]


def _parsed(mod, spec):
    """(verdict, fields or the message) of parsing and validating at N."""
    try:
        s = mod.parse_topology(spec)
        s.validate(N)
    except ValueError as e:
        return "reject", str(e)
    return "accept", (s.kind, s.degree, s.rows, s.cols, s.graph_seed,
                      s.metadata(N), s.spec_string(), s.diameter(1000))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_grammar_matches_jax(spec):
    """Every kind, malformed specs, aliasing expanders, a bad torus and a
    dense random_regular: the same verdict, fields, metadata and message
    word for word."""
    assert _parsed(tgraphs, spec) == _parsed(jgraphs, spec)


CONFIGS = [
    dict(topology="torus2d:8x8"),
    dict(topology="ring:4", delivery="quorum"),
    dict(topology="ring:4", backend="express"),
    dict(topology="ring:4", committee_cap=4, committee_count=2,
         committee_size=8),
    dict(topology="ring:4", drop_prob=0.1),
    dict(topology="torus2d:4x4"),
    dict(committee_cap=4, committee_count=5, committee_size=8),
    dict(committee_cap=65, committee_count=2, committee_size=8),
    dict(committee_cap=4, committee_count=2, committee_size=0),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         delivery="quorum"),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         backend="native"),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         fault_model="equivocate"),
    dict(committee_size=8),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         partition="halves:3"),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_config_verdicts_match_jax(kw):
    """SimConfig's topology and committee checks: the JAX verdict, and its
    message word for word."""
    def verdict(cls):
        try:
            c = cls(n_nodes=N, n_faulty=4, **kw)
        except ValueError as e:
            return "reject", str(e)
        return "accept", c.topology, c.committee_cap
    assert verdict(bt.SimConfig) == verdict(JCfg)


# --- tables and neighbour ids --------------------------------------------

KIND_SPECS = ["ring:6", "torus2d:8x8", "expander:8", "random_regular:6:{}"]


@pytest.mark.parametrize("graph_seed", [1, 7])
@pytest.mark.parametrize("spec", KIND_SPECS)
def test_neighbor_tables_match_jax(spec, graph_seed):
    """``build_neighbor_table`` equals JAX's element for element (the
    random_regular repair loop included), and ``neighbor_ids`` on the
    global ids equals JAX's ``neighbor_ids``."""
    spec = spec.format(graph_seed)
    want = jgraphs.build_neighbor_table(jgraphs.parse_topology(spec), N)
    got = tgraphs.build_neighbor_table(tgraphs.parse_topology(spec), N)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ids = np.arange(N, dtype=np.int32)
    jn = jdeliver.neighbor_ids(JCfg(n_nodes=N, n_faulty=0, topology=spec),
                               jnp.asarray(ids))
    tn = tdeliver.neighbor_ids(bt.SimConfig(n_nodes=N, n_faulty=0,
                                            topology=spec),
                               torch.from_numpy(ids).to(torch.int64))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tn.numpy(), want)


# --- the neighbourhood tally ---------------------------------------------

TALLY_MODES = {
    "crash": dict(topology="torus2d:8x8"),
    "byzantine": dict(topology="expander:6", fault_model="byzantine"),
    "equivocate": dict(topology="random_regular:6:1",
                       fault_model="equivocate"),
    "partition": dict(topology="ring:6", partition="halves:3"),
}


def _tally_inputs(mode):
    gen = np.random.default_rng(11)
    sent = gen.integers(0, 3, size=(T, N), dtype=np.int8)
    alive = gen.random((T, N)) < 0.8
    equiv = (gen.random((T, N)) < 0.2) if "equivocate" in mode else None
    return sent, alive, equiv


def _jax_neighborhood_counts(mode, r):
    """JAX's tally in both phases, op by op (a worker's call, see
    torch_ref_pool)."""
    sent, alive, equiv = _tally_inputs(mode)
    jc = JCfg(n_nodes=N, n_faulty=6, trials=T, **TALLY_MODES[mode])
    return [np.asarray(jdeliver.neighborhood_counts(
        jc, jax.random.key(SEED), r, phase, jnp.asarray(sent),
        jnp.asarray(alive),
        equiv=None if equiv is None else jnp.asarray(equiv)))
        for phase in (trng.PHASE_PROPOSAL, trng.PHASE_VOTE)]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("mode", list(TALLY_MODES))
@prefetch(lambda mode, r: [(_jax_neighborhood_counts, mode, r)])
def test_neighborhood_counts_match_jax(mode, r):
    """``neighborhood_counts`` on one round's random senders: crash
    (dead neighbours silent), byzantine on an expander (its flipped
    values are sent values like any other here), equivocate (the per-edge
    bits, self edge included) and a partition across a ring (its boundary
    edges silent at r = 1, back at the heal r = 3)."""
    kw = TALLY_MODES[mode]
    sent, alive, equiv = _tally_inputs(mode)
    tc = bt.SimConfig(n_nodes=N, n_faulty=6, trials=T, **kw)
    wants = ref(_jax_neighborhood_counts, mode, r)
    for phase, want in zip((trng.PHASE_PROPOSAL, trng.PHASE_VOTE), wants):
        got = tdeliver.neighborhood_counts(
            tc, SEED, r, phase, torch.from_numpy(sent),
            torch.from_numpy(alive),
            None if equiv is None else torch.from_numpy(equiv))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if mode == "partition" and r == 1:
        # the ring's four boundary lanes (0, 31, 32, 63) lose two edges
        full = tdeliver.neighborhood_counts(
            tc.replace(partition=None), SEED, r, 0, torch.from_numpy(sent),
            torch.from_numpy(alive))
        lost = (full - got).sum(-1)
        assert bool((lost >= 0).all()) and int(lost.sum()) > 0


# --- committees -----------------------------------------------------------

def _committee_inputs():
    gen = np.random.default_rng(12)
    sent = gen.integers(0, 3, size=(T, N), dtype=np.int8)
    alive = gen.random((T, N)) < 0.9
    return sent, alive


def _jax_committees(count, size):
    """JAX's membership and committee tally at rounds 1 and 2, op by op
    (a worker's call, see torch_ref_pool)."""
    jc = JCfg(n_nodes=N, n_faulty=2, trials=T, committee_cap=4,
              committee_count=count, committee_size=size)
    sent, alive = _committee_inputs()
    out = []
    for r in (1, 2):
        jm, jcid = jcom.membership(jc, jax.random.key(SEED), r,
                                   jrng.ids(T), jrng.ids(N), count, size)
        want = jcom.committee_counts(jc, jnp.asarray(sent),
                                     jnp.asarray(alive) & jm, jcid)
        out.append((np.asarray(jm), np.asarray(jcid), np.asarray(want)))
    return out


@pytest.mark.parametrize("count,size", [(3, 12), (4, 64)])
@prefetch(lambda count, size: [(_jax_committees, count, size)])
def test_committees_match_jax(count, size):
    """``membership`` (f32 p = min(1, c g / N), the clipped committee id)
    and ``committee_counts`` equal JAX's, a saturated size included."""
    tc = bt.SimConfig(n_nodes=N, n_faulty=2, trials=T, committee_cap=4,
                      committee_count=count, committee_size=size)
    sent, alive = _committee_inputs()
    for r, (jm, jcid, want) in zip((1, 2), ref(_jax_committees, count,
                                               size)):
        tm, tcid = tcom.membership(tc, SEED, r, trng.ids(T), trng.ids(N),
                                   count, size)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_equal(tcid.numpy(), jcid)
        got = tcom.committee_counts(tc, torch.from_numpy(sent),
                                    torch.from_numpy(alive) & tm, tcid)
        np.testing.assert_array_equal(got.numpy(), want)


# --- whole runs -------------------------------------------------------------

# name -> (config overrides, faults: "none" | "first_f" | crash round)
RUNS = {
    "torus2d_crash_debug": (dict(topology="torus2d:8x8", n_faulty=4,
                                 debug=True), "first_f"),
    "expander6_equivocate": (dict(topology="expander:6", n_faulty=6,
                                  fault_model="equivocate"), "first_f"),
    "random_regular_crash_at_2": (dict(topology="random_regular:6:1",
                                       n_faulty=6,
                                       fault_model="crash_at_round"), 2),
    "ring6_byzantine_halves3": (dict(topology="ring:6", n_faulty=6,
                                     fault_model="byzantine",
                                     partition="halves:3"), "first_f"),
    "committees": (dict(committee_cap=4, committee_count=3,
                        committee_size=12, n_faulty=2), "first_f"),
}


def _cfg(cls, name):
    over, _ = RUNS[name]
    return cls(n_nodes=N, trials=T, max_rounds=24, seed=SEED, **over, **OBS)


def _simulate(pkg, cfg, name, **kw):
    _, kind = RUNS[name]
    vals = random_inputs(SEED, T, N)
    faulty = [i < cfg.n_faulty for i in range(N)]
    if kind == "none":
        spec = JFaults if pkg is jsim else TFaults
        return pkg.simulate(cfg, vals, faults=spec.none(T, N), **kw)
    if isinstance(kind, int):
        return pkg.simulate(cfg, vals, faulty,
                            crash_rounds=[kind] * N, **kw)
    return pkg.simulate(cfg, vals, faulty, **kw)


def _jax_run(name):
    """JAX's run of a mode, every flag armed, and the rows its debug
    sink saw (a worker's call, see torch_ref_pool)."""
    events = []
    sink = lambda *e: events.append(e)  # noqa: E731
    jtracing.add_sink(sink)
    try:
        jout = _simulate(jsim, _cfg(JCfg, name), name)
        jax.effects_barrier()
    finally:
        jtracing.remove_sink(sink)
    return (int(jout[0]), {k: np.asarray(getattr(jout[1], k))
                           for k in FIELDS},
            [None if o is None else np.asarray(o) for o in jout[2:]],
            events)


@pytest.fixture(scope="module")
def runs():
    """name -> (port output, JAX output, port events, JAX events): one run
    of each package a mode, every flag armed; the debug mode's events
    collected by a sink in each package."""
    out = {}

    def run(name):
        if name not in out:
            events = []
            sink = lambda *e: events.append(e)  # noqa: E731
            ttracing.add_sink(sink)
            try:
                tout = _simulate(bt, _cfg(bt.SimConfig, name), name,
                                 device="cpu")
            finally:
                ttracing.remove_sink(sink)
            jr, jfields, jtails, jevents = ref(_jax_run, name)
            jout = (jr, types.SimpleNamespace(**jfields), *jtails)
            out[name] = (tout, jout, events, jevents)
        return out[name]
    return run


@pytest.mark.parametrize("name", list(RUNS))
@prefetch(lambda name: [(_jax_run, name)])
def test_simulate_matches_jax(name, runs):
    """Rounds, final x / decided / k / killed, recorder and witness equal
    JAX's; no kernel wrapper is reached; under debug the sinks of both
    packages saw the same rows, one a round."""
    for ops in (thist, tround, tdense):
        ops.reset_launches()
    tout, jout, tev, jev = runs(name)
    for table in (thist.KERNELS, tround.KERNELS, tdense.KERNELS):
        assert all(fn.launches == 0 for fn in table.values())
    assert len(tout) == len(jout) == 5
    assert tout[0] == int(jout[0]) >= 1
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tout[1], k).numpy(),
                                      np.asarray(getattr(jout[1], k)),
                                      err_msg=k)
    for i, what in ((3, "recorder"), (4, "witness")):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]),
                                      err_msg=what)
    assert tev == jev
    if RUNS[name][0].get("debug"):
        assert len(tev) == tout[0]
        assert tev[-1] == (int(tout[1].k.max()), int(tout[1].decided.sum()),
                           int(tout[1].killed.sum()))


def test_gate_bar_under_topology_and_partition():
    """Under a topology the per-lane gate's bar is d + 1 - F, not N - F:
    on ring:4 with F = 1 cut into halves, the four lanes beside a cut
    tally 3 < 4 and stall, every other lane tallies 5 unanimous 1s and
    decides in round 1 (the global bar N - F = 63 would stall them all)."""
    cfg = bt.SimConfig(n_nodes=N, n_faulty=1, trials=2, max_rounds=1,
                       topology="ring:4", partition="halves:3")
    _, st, _ = bt.simulate(cfg, np.ones((2, N), np.int8),
                           faults=TFaults.none(2, N), device="cpu")
    stalled = torch.zeros(N, dtype=torch.bool)
    stalled[[0, 31, 32, 63]] = True
    assert bool((st.decided == ~stalled).all())
    assert bool((st.k == torch.where(stalled, 1, 2)).all())


def test_complete_is_the_run_without_topology():
    """'complete' normalises to None: its run is the run without a
    topology, bit for bit."""
    cfgs = [bt.SimConfig(n_nodes=N, n_faulty=4, trials=T, max_rounds=24,
                         seed=SEED, topology=t) for t in ("complete", None)]
    assert cfgs[0].topology is None and cfgs[0] == cfgs[1]
    outs = [bt.simulate(c, random_inputs(SEED, T, N),
                        [i < 4 for i in range(N)], device="cpu")
            for c in cfgs]
    assert outs[0][0] == outs[1][0]
    for k in FIELDS:
        assert torch.equal(getattr(outs[0][1], k), getattr(outs[1][1], k))


def test_port_witness_audits_clean_under_torus(runs):
    """The port's torus2d:8x8 witness, bundled as the JAX package's
    WitnessBundle: the tally bound is the d + 1 = 5 neighbourhood, the
    run audits clean, and a forged tally of 6 is caught."""
    tout = runs("torus2d_crash_debug")[0]
    jc = _cfg(JCfg, "torus2d_crash_debug")
    wit = tout[4].numpy()
    bundle = jaudit.WitnessBundle.from_run(jc, wit, label="port torus")
    assert bundle.tally_bound == 5
    report = jaudit.audit_witness(bundle)
    assert report.ok, report.violations
    assert report.checks["quorum_evidence"] > 0
    forged = wit.copy()
    forged[1, 0, 0, tstate.WIT_P0] = 6
    bad = jaudit.audit_witness(jaudit.WitnessBundle.from_run(jc, forged))
    assert any(v.invariant == "quorum_evidence" and v.round == 1
               for v in bad.violations), bad.violations


@pytest.mark.parametrize("name", ["torus2d_crash_debug", "committees"])
def test_launch_network_runs_structured_planes(name, runs):
    """The facade takes topology and committee configs on backend='tpu':
    a one-trial network launched on trial 0's inputs ends in simulate's
    trial 0 (the streams key on the trial id; a settled trial stays as it
    is while the others run on)."""
    cfg = _cfg(bt.SimConfig, name).replace(trials=1, witness_trials=None,
                                           witness_nodes=0)
    net = bt.launch_network(N, cfg.n_faulty, random_inputs(SEED, T, N)[0],
                            [i < cfg.n_faulty for i in range(N)],
                            cfg=cfg, device="cpu")
    net.start()
    tout = runs(name)[0]
    assert 1 <= net.rounds_executed <= tout[0]
    for k in FIELDS:
        assert torch.equal(getattr(net.state, k)[0],
                           getattr(tout[1], k)[0]), k


@pytest.mark.parametrize("kw,plane", [
    (dict(topology="ring:4", use_pallas_round=True), "'topology'"),
    (dict(committee_cap=2, committee_count=2, committee_size=8,
          use_pallas_hist=True), "'committee'"),
    (dict(partition="halves:2", use_pallas_hist=True), "partition"),
], ids=["topology", "committee", "partition"])
def test_demotions_announced(kw, plane, monkeypatch):
    """Asking for the fused kernels on a plane they never serve runs the
    unfused loop, announced once per process with the JAX package's text;
    no kernel launches."""
    from benor_tpu_torch import sim as tsim
    for flag in ("_structured_demotion_warned", "_faults_demotion_warned"):
        monkeypatch.setattr(tsim, flag, False)
    cfg = bt.SimConfig(n_nodes=N, n_faulty=4, trials=2, max_rounds=4, **kw)
    assert tbenor.round_gap(cfg) is None
    tround.reset_launches()
    with pytest.warns(UserWarning, match=plane):
        bt.simulate(cfg, random_inputs(SEED, 2, N),
                    faults=TFaults.none(2, N), device="cpu")
    assert all(fn.launches == 0 for fn in tround.KERNELS.values())
