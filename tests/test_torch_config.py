"""benor_tpu_torch's SimConfig against benor_tpu's: fields, defaults,
validation verdicts, derived properties, and the port's JAX-free import."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benor_tpu import config as jcfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu.ops import tally as jtally
from benor_tpu_torch import config as tcfg
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally

REPO = Path(__file__).resolve().parent.parent


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SimConfig)]
    assert tf == jf
    for name in ("VAL0", "VAL1", "VALQ", "BASE_NODE_PORT",
                 "WITNESS_MAX_NODES"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


_BASE = dict(n_nodes=96, n_faulty=24)
VERDICT_MATRIX = [
    {},
    dict(n_nodes=0),
    dict(n_faulty=-1),
    dict(n_faulty=97),
    dict(rule="textbook"),
    dict(rule="bogus"),
    dict(coin_mode="common"),
    dict(coin_mode="coin"),
    dict(coin_mode="weak_common", coin_eps=0.5),
    dict(coin_eps=0.5),
    dict(coin_mode="weak_common", coin_eps=1.5),
    dict(delivery="quorum", scheduler="targeted"),
    dict(delivery="carrier"),
    dict(scheduler="adversarial"),
    dict(delivery="quorum", scheduler="bogus"),
    dict(path="dense"),
    dict(path="sparse"),
    dict(fault_model="byzantine"),
    dict(fault_model="meltdown"),
    dict(fault_model="crash_recover", backend="express"),
    dict(fault_model="crash_recover", recovery="at:2:3"),
    dict(fault_model="crash_recover", recovery="stagger:1:4:amnesia"),
    dict(fault_model="crash_recover", recovery="at:0:3"),
    dict(fault_model="crash_recover", recovery="bogus:1:2"),
    dict(fault_model="crash_at_round", recovery="at:2:3"),
    dict(drop_prob=0.1),
    dict(drop_prob=1.0),
    dict(drop_prob=0.1, delivery="quorum"),
    dict(drop_prob=0.1, backend="native"),
    dict(drop_prob=0.1, fault_model="equivocate"),
    dict(drop_prob=0.1, committee_cap=4, committee_count=2,
         committee_size=8),
    dict(fault_model="equivocate", scheduler="biased", delivery="quorum"),
    dict(committee_cap=-1),
    dict(committee_cap=4, committee_count=2, committee_size=8),
    dict(committee_cap=4, committee_count=5, committee_size=8),
    dict(committee_cap=200, committee_count=2, committee_size=8),
    dict(committee_cap=4, committee_count=2, committee_size=0),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         delivery="quorum"),
    dict(committee_cap=4, committee_count=2, committee_size=8,
         fault_model="equivocate"),
    dict(committee_count=2),
    dict(poll_rounds=-1),
    dict(heartbeat_rounds=-1),
    dict(heartbeat_rounds=2, backend="express"),
    dict(poll_rounds=2, backend="native"),
    dict(use_pallas_round=True, max_rounds=(1 << 25) - 1),
    dict(use_pallas_round=True, max_rounds=(1 << 25) - 2),
    dict(trials=4, witness_trials=(3, 1, 1), witness_nodes=4),
    dict(trials=4, witness_trials=(), witness_nodes=4),
    dict(trials=4, witness_trials=(4,), witness_nodes=4),
    dict(trials=4, witness_trials=(0,), witness_nodes=0),
    dict(trials=4, witness_trials=(0,), witness_nodes=17),
    dict(trials=4, witness_trials=(0,), witness_nodes=2, backend="native"),
    dict(witness_nodes=3),
    dict(kernel_telemetry=True),
    dict(kernel_telemetry=True, mesh_shape=(1, 2)),
    dict(kernel_telemetry=True, backend="express"),
    dict(record=True, backend="express"),
    dict(backend="gpu"),
    dict(oracle_order="lifo"),
    dict(topology="complete"),
]


def _verdict(cls, kw):
    try:
        cfg = cls(**{**_BASE, **kw})
    except ValueError:
        return "reject"
    return ("accept", cfg.topology, cfg.witness_trials)


@pytest.mark.parametrize("kw", VERDICT_MATRIX, ids=str)
def test_validation_verdicts_match(kw):
    assert _verdict(tcfg.SimConfig, kw) == _verdict(jcfg.SimConfig, kw)


@pytest.mark.parametrize("kw", [
    dict(partition="halves:5"),
    dict(topology="ring:4"),
])
def test_unported_spec_grammars_raise(kw):
    """The spec grammars that once raised here are ported: the partition
    grammar and the topology grammar, whose valid specs the port accepts
    as the JAX package does, keeping the spec."""
    jc = jcfg.SimConfig(**{**_BASE, **kw})
    tc = tcfg.SimConfig(**{**_BASE, **kw})
    assert (tc.partition, tc.topology) == (jc.partition, jc.topology)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=96, n_faulty=24),
    dict(n_nodes=4096, n_faulty=0, path="auto"),
    dict(n_nodes=2048, n_faulty=100),
    dict(n_nodes=2049, n_faulty=1000, dense_path_max_n=4096),
    dict(n_nodes=1_000_000, n_faulty=450_000, path="histogram"),
])
def test_quorum_and_resolved_path_match(kw):
    j, t = jcfg.SimConfig(**kw), tcfg.SimConfig(**kw)
    assert (t.quorum, t.resolved_path, t.witness) == \
        (j.quorum, j.resolved_path, j.witness)
    assert t.replace(n_faulty=3).quorum == j.replace(n_faulty=3).quorum


_GATES = ("pallas_stream_active", "pallas_hist_active",
          "pallas_round_active", "pallas_round_counts_mode",
          "dense_gather_needed")


@pytest.mark.parametrize("table_max", [4096, 4])
def test_gate_predicates_match(table_max):
    """The port's kernel gates agree with the JAX package's on every config
    of a matrix crossing each gated knob, at both regime boundaries."""
    old = jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = tsampling.EXACT_TABLE_MAX = table_max
    try:
        base = dict(n_nodes=96, n_faulty=24, delivery="quorum",
                    path="histogram", use_pallas_hist=True,
                    use_pallas_round=True)
        for kw in ({}, dict(use_pallas_hist=False),
                   dict(use_pallas_round=False), dict(delivery="all"),
                   dict(path="auto"), dict(path="dense"),
                   dict(path="dense", delivery="all", drop_prob=0.1),
                   dict(delivery="all", drop_prob=0.1),
                   dict(scheduler="adversarial"), dict(scheduler="targeted"),
                   dict(scheduler="biased", adversary_strength=1.0),
                   dict(fault_model="equivocate"),
                   dict(fault_model="byzantine"), dict(coin_mode="common"),
                   dict(coin_mode="weak_common", coin_eps=0.5),
                   dict(coin_mode="weak_common", coin_eps=1.0),
                   dict(n_nodes=6000, n_faulty=1000),
                   dict(n_nodes=6000, n_faulty=1000, path="auto")):
            cfg = {**base, **kw}
            j, t = jcfg.SimConfig(**cfg), tcfg.SimConfig(**cfg)
            for gate in _GATES:
                assert getattr(ttally, gate)(t) == \
                    getattr(jtally, gate)(j), (gate, kw)
    finally:
        jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX = old


def test_port_imports_without_jax_or_the_jax_package():
    """With ``jax`` made unimportable, the port imports (the request plane
    and the heartbeat included) and runs a CPU simulation, and no
    ``benor_tpu`` module is ever loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import benor_tpu_torch
        import benor_tpu_torch.meshscope, benor_tpu_torch.serve
        from benor_tpu_torch import SimConfig, simulate
        from benor_tpu_torch.ops import sampling
        from benor_tpu_torch.sweep import balanced_inputs
        sampling.EXACT_TABLE_MAX = 4
        cfg = SimConfig(n_nodes=64, n_faulty=16, trials=2,
                        delivery="quorum", scheduler="uniform",
                        path="histogram", use_pallas_hist=True,
                        use_pallas_round=True, max_rounds=8)
        r, st, _ = simulate(cfg, balanced_inputs(2, 64),
                            [True] * 16 + [False] * 48, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m == "benor_tpu" or m.startswith("benor_tpu."))
        print("OK", r, bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("OK"), out.stdout
    assert out.stdout.strip().endswith("[]"), out.stdout
