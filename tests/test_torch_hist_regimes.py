"""Whole runs of the histogram path's remaining count sources and of the
omission and partition planes: ``benor_tpu_torch.run_consensus`` on the
CPU against the JAX package's ``run_consensus`` — the rounds, the final
x / decided / k / killed, the flight recorder and the witness buffer all
equal — then the port's witness audited by the JAX package's auditor.

The modes: the biased scheduler at strengths 0.5, 1.0 and 1.5, the
uniform scheduler with ``use_pallas_hist=False`` and equivocation on the
plain sampler, in the CF regime (``EXACT_TABLE_MAX`` lowered in both
packages); the exact-table regime (the default bound) under the uniform
scheduler, the strict biased scheduler and equivocation, with the port's
``hypergeom_cdf_table`` handed JAX's table for the same inputs (the
table's own rounding is tests/test_torch_samplers.py's); ``delivery=
'all'`` with ``drop_prob`` on the histogram path; ``'halves:3'`` and
``'groups:3:3'`` with and without ``drop_prob`` on the histogram path and
``'halves:3'`` with ``drop_prob`` on the dense path.  Every mode arms the
recorder and the witness, so each compiles once on the JAX side; the JAX
side's caches are dropped when the module is done."""

import jax
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import audit as jaudit
from benor_tpu import sim as jsim
from benor_tpu import state as jstate
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import state as tstate
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import hist as thist
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs, random_inputs
from torch_ref_pool import prefetch, ref, start

FIELDS = ("x", "decided", "k", "killed")
N, T = 96, 8
OBS = dict(record=True, witness_trials=(0, 3, 5), witness_nodes=6)
J_TABLE = jax.jit(jsampling.hypergeom_cdf_table, static_argnums=2)

_Q = dict(delivery="quorum", path="histogram", use_pallas_hist=True,
          use_pallas_round=True)
# name -> (config overrides, faults: "none" | "first_f", table regime):
# "cf" lowers EXACT_TABLE_MAX in both packages, "exact" keeps the default
# and hands the port JAX's CDF tables.  Seeds differ between the modes, so
# no two share a JAX executable.
MODES = {
    "biased_s0.5": (dict(_Q, scheduler="biased", adversary_strength=0.5,
                         n_faulty=40, seed=21), "none", "cf"),
    "biased_s1.0": (dict(_Q, scheduler="biased", adversary_strength=1.0,
                         n_faulty=40, seed=22), "first_f", "cf"),
    "biased_s1.5": (dict(_Q, scheduler="biased", adversary_strength=1.5,
                         n_faulty=30, seed=23), "first_f", "cf"),
    "uniform_xla": (dict(_Q, use_pallas_hist=False, n_faulty=40, seed=24),
                    "none", "cf"),
    "equiv_cf": (dict(_Q, use_pallas_hist=False, fault_model="equivocate",
                      n_faulty=30, seed=25), "first_f", "cf"),
    "exact_uniform": (dict(_Q, n_faulty=40, seed=26), "none", "exact"),
    "exact_biased_strict": (dict(_Q, scheduler="biased",
                                 adversary_strength=1.5, n_faulty=30,
                                 seed=27), "first_f", "exact"),
    "equiv_exact": (dict(_Q, fault_model="equivocate", n_faulty=30,
                         seed=28), "first_f", "exact"),
    "all_drop": (dict(delivery="all", path="histogram", drop_prob=0.05,
                      n_faulty=40, seed=29), "none", "cf"),
    "halves3": (dict(delivery="all", path="histogram", partition="halves:3",
                     n_faulty=20, seed=30), "first_f", "cf"),
    "groups3_3": (dict(delivery="all", path="histogram",
                       partition="groups:3:3", n_faulty=20, seed=31),
                  "first_f", "cf"),
    "halves3_drop": (dict(delivery="all", path="histogram",
                          partition="halves:3", drop_prob=0.05,
                          n_faulty=20, seed=32), "none", "cf"),
    "groups3_3_drop": (dict(delivery="all", path="histogram",
                            partition="groups:3:3", drop_prob=0.05,
                            n_faulty=20, seed=33), "none", "cf"),
    "halves3_drop_dense": (dict(delivery="all", path="dense",
                                partition="halves:3", drop_prob=0.05,
                                n_faulty=20, seed=34), "none", "cf"),
}
CF_MAX = 4


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _jax_table(total, good, m):
    """JAX's CDF table for the port's inputs, as the port's table."""
    return torch.from_numpy(np.array(J_TABLE(total.numpy(), good.numpy(),
                                             m)))


def _kw(name):
    over, _, _ = MODES[name]
    return dict(n_nodes=N, trials=T, max_rounds=16, **over, **OBS)


def _faults(spec_cls, cfg, kind):
    return spec_cls.none(T, N) if kind == "none" else spec_cls.first_f(cfg)


@pytest.fixture(scope="module")
def port_runs():
    """The port's run of each mode, shared with the audit test."""
    return {}


def _port_run(name, port_runs, monkeypatch):
    if name not in port_runs:
        _, kind, regime = MODES[name]
        tc = bt.SimConfig(**_kw(name))
        tf = _faults(TFaults, tc, kind)
        with monkeypatch.context() as mp:
            if regime == "cf":
                mp.setattr(tsampling, "EXACT_TABLE_MAX", CF_MAX)
            else:
                mp.setattr(tsampling, "hypergeom_cdf_table", _jax_table)
            port_runs[name] = (tc, tf, bt.run_consensus(
                tc, bt.init_state(tc, balanced_inputs(T, N), tf), tf))
    return port_runs[name]


def _jax_mode(name):
    """The JAX package's run_consensus of a mode, recorder and witness
    armed (a worker's call, see torch_ref_pool)."""
    _, kind, regime = MODES[name]
    jc = JCfg(**_kw(name))
    jf = _faults(JFaults, jc, kind)
    old = jsampling.EXACT_TABLE_MAX
    if regime == "cf":
        jsampling.EXACT_TABLE_MAX = CF_MAX
    try:
        jout = jsim.run_consensus(jc, jstate.init_state(
            jc, balanced_inputs(T, N), jf), jf, jax.random.key(jc.seed))
    finally:
        jsampling.EXACT_TABLE_MAX = old
    return (int(jout[0]), {k: np.asarray(getattr(jout[1], k))
                           for k in FIELDS},
            [np.asarray(o) for o in jout[2:]])


@pytest.mark.parametrize("name", list(MODES))
@prefetch(lambda name: [(_jax_mode, name)])
def test_regime_matches_jax(name, port_runs, monkeypatch):
    """Rounds, final state, recorder and witness equal the JAX package's;
    no kernel wrapper is reached (no TPU kernel lies on these branches);
    the partition modes stall until the heal, then decide."""
    over, kind, regime = MODES[name]
    for ops in (thist, tround, tdense):
        ops.reset_launches()
    jr, jfields, jtails = ref(_jax_mode, name)
    jout = (jr, jfields, *jtails)
    tc, _, tout = _port_run(name, port_runs, monkeypatch)
    assert not ttally.pallas_round_active(tc)
    for table in (thist.KERNELS, tround.KERNELS, tdense.KERNELS):
        assert all(fn.launches == 0 for fn in table.values())
    assert len(tout) == len(jout) == 4
    assert tout[0] == jout[0] >= 1
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tout[1], k).numpy(),
                                      jout[1][k], err_msg=k)
    for i, what in ((2, "recorder"), (3, "witness")):
        np.testing.assert_array_equal(tout[i].numpy(), jout[i],
                                      err_msg=what)
    if "partition" in over and "drop_prob" not in over:
        # every lane stalls inside the epoch, then the run decides
        heal = 3
        fin = tout[1]
        live = ~fin.killed
        assert bool(fin.decided[live].all())
        assert bool((fin.k[fin.decided] > heal).all())
        assert tout[0] >= heal


# --- the port's witness, audited by the JAX package's auditor ------------

# bench.py:1677-1698's faultlab points: the partition (default faults, the
# first F lanes crashed, random inputs) and the omission (no crashes)
BENCH_POINTS = {
    "partition": (dict(n_nodes=64, n_faulty=8, partition="halves:4"),
                  "first_f"),
    "omission": (dict(n_nodes=64, n_faulty=16, drop_prob=0.05), "none"),
}


@pytest.mark.parametrize("point", list(BENCH_POINTS))
def test_port_witness_audits_clean(point):
    """bench.py's faultlab audit points run on the port, their witness
    bundled as the JAX package's WitnessBundle: clean, the partition's
    epoch bound checked — and a forged in-epoch tally above the group size
    caught."""
    over, kind = BENCH_POINTS[point]
    trials = 16
    cfg = bt.SimConfig(trials=trials, max_rounds=24, seed=0,
                       witness_trials=(0, 1), witness_nodes=12, **over)
    jc = JCfg(trials=trials, max_rounds=24, seed=0, witness_trials=(0, 1),
              witness_nodes=12, **over)
    faults = (TFaults.none(trials, cfg.n_nodes) if kind == "none"
              else TFaults.first_f(cfg))
    out = bt.run_consensus(cfg, bt.init_state(
        cfg, random_inputs(cfg.seed, trials, cfg.n_nodes), faults), faults)
    wit = out[-1].numpy()
    report = jaudit.audit_witness(jaudit.WitnessBundle.from_run(
        jc, wit, faults=None, label=f"port {point}"))
    assert report.ok, report.violations
    assert sum(report.checks.values()) > 0
    if point != "partition":
        return
    assert report.checks["quorum_evidence"] > 0
    # a tally above the group size inside the epoch is forged evidence
    forged = wit.copy()
    forged[1, 0, 0, tstate.WIT_P0] = cfg.n_nodes // 2 + 1
    bad = jaudit.audit_witness(jaudit.WitnessBundle.from_run(jc, forged))
    hits = [v for v in bad.violations if v.invariant == "quorum_evidence"]
    assert any(v.round == 1 and v.trial == 0 for v in hits), bad.violations


def test_partition_modes_audit_clean(port_runs, monkeypatch):
    """The partition and omission modes' port witnesses audit clean too."""
    for name in ("halves3", "groups3_3_drop", "halves3_drop_dense",
                 "all_drop"):
        tc, _, out = _port_run(name, port_runs, monkeypatch)
        jc = JCfg(**_kw(name))
        report = jaudit.audit_witness(jaudit.WitnessBundle.from_run(
            jc, out[3].numpy(), label=name))
        assert report.ok, (name, report.violations)
