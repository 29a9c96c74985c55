"""The invariant auditor of benor_tpu_torch against the JAX package's, on the
CPU: ``audit_witness`` over the same bundles gives the same report (``ok``,
the checks, every violation's ``to_dict()`` in order, the summary line),
``WitnessBundle.from_run`` builds the same bundle from a port run, bundles
saved by either package load and audit in the other, and ``audit_point``
on a targeted-adversary config equals the JAX one.

The bundles come from port runs (the witness buffer equals the JAX
package's, tests/test_torch_observability.py): clean crash runs, the
targeted adversary's agreement break, one equivocator, a partition with
unanimous inputs, crash-recovery churn, a ring topology, full node
coverage; then the clean bundle with its buffer tampered in each way one
invariant forbids.  The JAX auditor is host numpy and runs here; the one
JAX run (``audit_point``) runs in the worker pool (torch_ref_pool)."""

import json
import os
import tempfile

import jax
import numpy as np
import pytest

import benor_tpu_torch as bt
from benor_tpu import audit as jaudit
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu_torch import audit as taudit
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.sim import run_consensus
from benor_tpu_torch.state import (WIT_COINED, WIT_DECIDED,
                                   WIT_P0, WIT_V0, WIT_V1, WIT_X, FaultSpec,
                                   init_state)
from benor_tpu_torch.sweep import balanced_inputs, default_crash_faults
from torch_ref_pool import prefetch, ref, start

CF_MAX = 4
T = 4


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool) and drop this module's
    compiled programs when it is done."""
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _cf_regime(monkeypatch):
    """The CF regime in the port, as the JAX side sets it for itself."""
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", CF_MAX)


def _witnessed(**kw):
    kw.setdefault("trials", T)
    cfg = bt.SimConfig(**kw)
    return cfg.replace(**taudit.default_witness_overrides(cfg.trials,
                                                          cfg.n_nodes))


# name -> (config, inputs, faults: "none" | "first_f" | "default",
#          unanimous asserted)
RUNS = {
    "crash_clean": (dict(n_nodes=40, n_faulty=10, delivery="quorum",
                         path="histogram", max_rounds=16, seed=1),
                    "random", "default", None),
    "textbook_clean": (dict(n_nodes=40, n_faulty=12, delivery="quorum",
                            path="histogram", rule="textbook",
                            max_rounds=16, seed=2),
                       "balanced", "default", None),
    "targeted_violation": (dict(n_nodes=96, n_faulty=6, delivery="quorum",
                                scheduler="targeted", path="histogram",
                                max_rounds=16, seed=3),
                           "balanced", "none", None),
    "one_equivocator": (dict(n_nodes=64, n_faulty=1, delivery="quorum",
                             scheduler="targeted", fault_model="equivocate",
                             path="histogram", max_rounds=16, seed=4),
                        "balanced", "first_f", None),
    "partition_unanimous": (dict(n_nodes=64, n_faulty=16,
                                 partition="halves:3", max_rounds=12,
                                 seed=5),
                            "ones", "none", 1),
    "crash_recover": (dict(n_nodes=48, n_faulty=12, delivery="quorum",
                           path="histogram", fault_model="crash_recover",
                           recovery="at:2:2", max_rounds=16, seed=6),
                      "balanced", "default", None),
    "ring_topology": (dict(n_nodes=48, n_faulty=4, topology="ring:4",
                           max_rounds=16, seed=7),
                      "random", "none", None),
    "full_cover": (dict(n_nodes=16, n_faulty=3, delivery="quorum",
                        path="histogram", max_rounds=16, seed=8),
                   "ones", "default", None),
}


# the runs whose verdict is known: the targeted adversary's camps and one
# equivocator break agreement inside the watched ids; crash faults that
# pin the live population to the quorum keep every invariant (churn lets
# all N vote in round 1, so its verdict is the JAX package's, whatever it
# is)
VIOLATING = ("targeted_violation", "one_equivocator")
CLEAN = ("crash_clean", "textbook_clean", "partition_unanimous",
         "full_cover")


def _inputs(kind, cfg):
    if kind == "balanced":
        return balanced_inputs(cfg.trials, cfg.n_nodes)
    if kind == "ones":
        return np.ones((cfg.trials, cfg.n_nodes), np.int8)
    return bt.sweep.random_inputs(cfg.seed, cfg.trials, cfg.n_nodes)


def _port_run(name):
    """The port's witness buffer and faults of one RUNS entry -> (cfg,
    buffer, faults, unanimous)."""
    kw, inputs, faults_kind, unanimous = RUNS[name]
    cfg = _witnessed(**kw)
    if faults_kind == "none":
        faults = FaultSpec.none(cfg.trials, cfg.n_nodes)
    elif faults_kind == "first_f":
        faults = FaultSpec.first_f(cfg)
    else:
        faults = default_crash_faults(cfg, "cpu")
    state = init_state(cfg, _inputs(inputs, cfg), faults)
    return cfg, run_consensus(cfg, state, faults)[-1], faults, unanimous


def _jax_bundle(cfg, bundle):
    """The JAX package's bundle of the same evidence."""
    return jaudit.WitnessBundle(**{
        f: getattr(bundle, f) for f in
        ("buffer", "trial_ids", "node_ids", "rule", "n_faulty", "n_nodes",
         "freeze_decided", "faulty", "unanimous", "tally_bound",
         "partition", "down_crash", "down_recover", "label")})


def _same_report(got, want):
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    assert [v.to_dict() for v in got.violations] == \
        [v.to_dict() for v in want.violations]


def _jax_cfg(cfg):
    """The JAX SimConfig of a port config (the same fields)."""
    import dataclasses
    return JCfg(**dataclasses.asdict(cfg))


class _Faults:
    """A FaultSpec's masks as numpy, the shape JAX's from_run reads."""

    def __init__(self, faults):
        self.faulty = faults.faulty.numpy()
        self.crash_round = faults.crash_round.numpy()
        self.recover_round = (None if faults.recover_round is None
                              else faults.recover_round.numpy())


@pytest.mark.parametrize("name", list(RUNS))
def test_audit_of_port_runs_matches_jax(name):
    """``from_run`` builds JAX's bundle from the same run (the watched
    faulty mask, the topology's tally bound, the partition, the down
    intervals), and both auditors give one report."""
    cfg, buf, faults, unanimous = _port_run(name)
    got_b = taudit.WitnessBundle.from_run(cfg, buf, faults=faults,
                                          unanimous=unanimous, label=name)
    want_b = jaudit.WitnessBundle.from_run(
        _jax_cfg(cfg), buf.numpy(), faults=_Faults(faults),
        unanimous=unanimous, label=name)
    assert got_b.to_dict() == want_b.to_dict()
    got = taudit.audit_witness(got_b)
    _same_report(got, jaudit.audit_witness(want_b))
    if name in VIOLATING:
        assert {v.invariant for v in got.violations} == {"agreement"}
    elif name in CLEAN:
        assert got.ok
    if name == "crash_recover":
        assert got.checks["down_silence"] > 0
    if name in ("partition_unanimous", "full_cover"):
        assert got.checks["validity"] == T


def _tamper(kind, buf):
    """One invariant's breach written into a copy of the textbook_clean
    buffer (4 written rows; watched lanes 0-7 killed from birth, lanes 8-15
    deciding at row 2, trial 1's at row 3)."""
    b = buf.copy()
    last = 3
    if kind == "revoke":
        b[last, 0, 8, WIT_DECIDED] = 0
    elif kind == "change_value":
        b[last, 0, 8, WIT_X] = 1 - b[last, 0, 8, WIT_X]
    elif kind == "forged_decide":
        b[1:, 1, 9, WIT_DECIDED] = 1
        b[1:, 1, 9, WIT_X] = 1
        b[1, 1, 9, WIT_V0] = b[1, 1, 9, WIT_V1] = 0
    elif kind == "decide_q":
        b[1:, 2, 10, WIT_DECIDED] = 1
        b[1:, 2, 10, WIT_X] = 2
    elif kind == "coin_on_decide":
        b[last, 0, 8, WIT_COINED] = 1
    elif kind == "killed_moves":
        b[last, 1, 3, WIT_X] = 1 - b[last, 1, 3, WIT_X]
        b[last, 1, 3, WIT_COINED] = 1
    elif kind == "opposite_decide":
        b[2:, 0, 9, WIT_X] = 1 - b[last, 0, 8, WIT_X]
        b[2, 0, 9, WIT_V0] = b[2, 0, 9, WIT_V1] = 40
    elif kind == "over_quorum":
        b[1, 3, 12, WIT_P0] = 1000
    return b


TAMPERS = ("revoke", "change_value", "forged_decide", "decide_q",
           "coin_on_decide", "killed_moves", "opposite_decide",
           "over_quorum")


@pytest.mark.parametrize("kind", TAMPERS)
@pytest.mark.parametrize("bound", ["plain", "tally_bound", "partition",
                                   "down_interval", "unanimous"])
def test_audit_of_tampered_buffers_matches_jax(kind, bound):
    """Each forbidden change to a clean buffer, under each of the extra
    bounds a bundle may carry: both auditors report the same violations
    in the same order."""
    cfg, buf, faults, _ = _port_run("textbook_clean")
    b = _tamper(kind, buf.numpy())
    extra = {}
    if bound == "tally_bound":
        extra["tally_bound"] = 9
    elif bound == "partition":
        extra["partition"] = "halves:3"
    elif bound == "down_interval":
        k = cfg.witness_nodes
        extra["down_crash"] = np.full((T, k), 2, np.int64)
        extra["down_recover"] = np.full((T, k), 4, np.int64)
    elif bound == "unanimous":
        extra["unanimous"] = 0
    got_b = taudit.WitnessBundle.from_run(cfg, b, faults=faults,
                                          label=kind)
    got_b = taudit.WitnessBundle(**{**got_b.__dict__, **extra})
    got = taudit.audit_witness(got_b)
    _same_report(got, jaudit.audit_witness(_jax_bundle(cfg, got_b)))
    # an over-quorum tally is caught only where a bound is armed
    if kind != "over_quorum" or bound in ("tally_bound", "partition"):
        assert not got.ok


def test_bundles_cross_the_packages():
    """A bundle saved by the port loads and audits in the JAX package, and
    one saved by the JAX package (the same document) in the port; the
    auditors' verdicts ride along equal."""
    cfg, buf, faults, _ = _port_run("targeted_violation")
    bundle = taudit.WitnessBundle.from_run(cfg, buf, faults=faults,
                                           label="cross")
    report = taudit.audit_witness(bundle)
    with tempfile.TemporaryDirectory() as d:
        p_port, p_jax = os.path.join(d, "port.json"), os.path.join(
            d, "jax.json")
        taudit.save_bundle(p_port, bundle, report)
        jb = _jax_bundle(cfg, bundle)
        jaudit.save_bundle(p_jax, jb, jaudit.audit_witness(jb))
        with open(p_port) as a, open(p_jax) as b:
            assert json.load(a) == json.load(b)
        into_jax = jaudit.load_bundle(p_port)
        into_port = taudit.load_bundle(p_jax)
    _same_report(taudit.audit_witness(into_port),
                 jaudit.audit_witness(into_jax))
    _same_report(taudit.audit_witness(into_port), report)
    assert not report.ok


def test_witness_rows_and_overrides_match_jax():
    """The row rendering of a buffer and the default watch set."""
    cfg, buf, _, _ = _port_run("crash_recover")
    ids = (cfg.witness_trials, bt.state.witness_node_ids(cfg))
    assert taudit.witness_rows(buf, *ids) == \
        jaudit.witness_rows(buf.numpy(), *ids)
    for trials, n in ((1, 3), (4, 16), (16, 100), (32, 1_000_000)):
        assert taudit.default_witness_overrides(trials, n) == \
            jaudit.default_witness_overrides(trials, n)
    assert taudit.INVARIANTS == jaudit.INVARIANTS


# --- audit_point -------------------------------------------------------------

POINT = dict(n_nodes=96, n_faulty=4, trials=T, delivery="quorum",
             scheduler="targeted", path="histogram", max_rounds=16, seed=9,
             witness_trials=(0, 2), witness_nodes=10)


def _jax_audit_point(kw, balanced):
    """JAX's audit_point -> (report dict, bundle dict)."""
    from benor_tpu.state import FaultSpec as JFaults
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = CF_MAX
    try:
        cfg = JCfg(**kw)
        iv = balanced_inputs(cfg.trials, cfg.n_nodes) if balanced else None
        faults = JFaults.none(cfg.trials, cfg.n_nodes) if balanced else None
        report, bundle = jaudit.audit_point(cfg, initial_values=iv,
                                            faults=faults, label="point")
        return report.to_dict(), bundle.to_dict()
    finally:
        jsampling.EXACT_TABLE_MAX = old


@pytest.mark.parametrize("balanced", [True, False])
@prefetch(lambda balanced: [(_jax_audit_point, POINT, balanced)])
def test_audit_point_matches_jax(balanced):
    """One witnessed run and its audit, from a config alone (run_point's
    default inputs and faults) and with balanced inputs and no crash: the
    report and the bundle are JAX's."""
    cfg = bt.SimConfig(**POINT)
    iv = balanced_inputs(T, cfg.n_nodes) if balanced else None
    faults = FaultSpec.none(T, cfg.n_nodes) if balanced else None
    report, bundle = taudit.audit_point(cfg, initial_values=iv,
                                        faults=faults, label="point",
                                        device="cpu")
    want_report, want_bundle = ref(_jax_audit_point, POINT, balanced)
    assert report.to_dict() == want_report
    assert bundle.to_dict() == want_bundle
    if balanced:
        assert not report.ok


def test_audit_point_refuses_an_unwitnessed_config():
    with pytest.raises(ValueError, match="witnessed config"):
        taudit.audit_point(bt.SimConfig(n_nodes=8, n_faulty=1),
                           device="cpu")
    with pytest.raises(ValueError, match="no witness armed"):
        taudit.WitnessBundle.from_run(bt.SimConfig(n_nodes=8, n_faulty=1),
                                      np.zeros((3, 1, 1, 9)))
