"""The port's metrics registry, span log and exporters against the JAX
package's (benor_tpu/utils/metrics.py), on the CPU.

Both registries driven through the same counter, gauge and timer
operations give equal snapshots and percentiles (the timers record fixed
durations and starts, so no clock enters); the three exporters write equal
documents from fixed inputs (fixed timer spans, a fixed recorder and
witness buffer, a span set with parents and flows; JSON-lines' ``ts`` is
the clock and is left out).  The counters the JAX package ticks tick alike
in the port: ``sweepscope.journal.buckets`` / ``.tampered`` on the same
journal records and tamperings, ``audit.*`` on the same audited bundles,
and ``atlas.*`` on one heatmap and one cliff search, where the JAX counts
are read off the JAX documents (each tick adds the length of a list the
document carries) computed in the worker pool (torch_ref_pool).  The
demotion counters count calls in the port (one JAX tick is one traced
build), and ``profile_trace`` writes a ``torch.profiler`` capture and
ticks its counter."""

import json
import os
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import audit as jaudit
from benor_tpu.sweepscope import journal as jjournal
from benor_tpu.utils import metrics as jm
from benor_tpu.utils import tracing as jtracing
from benor_tpu_torch import audit as taudit
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.atlas import search as tsearch
from benor_tpu_torch.atlas import manifest as tmanifest
from benor_tpu_torch.sweepscope import journal as tjournal
from benor_tpu_torch.utils import metrics as tm
from benor_tpu_torch.utils import tracing as ttracing
from test_torch_atlas import HEAT, HEAT_BASE, _jax_find_cliffs, _jax_heatmap
from torch_ref_pool import prefetch, ref, start


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture
def registries():
    """Both process-wide registries, emptied before and after the test."""
    jm.REGISTRY.reset()
    tm.REGISTRY.reset()
    yield tm.REGISTRY, jm.REGISTRY
    jm.REGISTRY.reset()
    tm.REGISTRY.reset()


def _drive(m):
    """One sequence of registry operations on module ``m`` -> (snapshot,
    percentiles, the type-conflict error, the timer's events)."""
    reg = m.MetricsRegistry()
    reg.counter("a.events").inc()
    reg.counter("a.events").inc(2.5)
    reg.counter("b.bytes").inc(0)
    reg.gauge("g.size").set(7)
    reg.gauge("g.size").set(3.25)
    reg.gauge("g.flag").set(True)
    t = reg.timer("t.run")
    for start, dur in ((100.0, 0.5), (100.25, 0.125), (101.0, 2.0),
                       (102.5, 0.0625)):
        t.record(dur, start=start)
    reg.timer("t.empty")
    try:
        reg.gauge("a.events")
        err = None
    except TypeError as e:
        err = str(e)
    out = (reg.snapshot(), t.percentiles(), t.percentiles((10, 50, 90)),
           reg.timer("t.empty").percentiles(), err, list(t.events))
    reg.reset()
    return out + (reg.snapshot(),)


def test_registry_operations_match_jax():
    got, want = _drive(tm), _drive(jm)
    assert got == want
    assert got[4] is not None and got[-1] == []


def _spans(m):
    """A fixed span set: a batch span whose flows end in two children."""
    return [
        m.Span(name="batch", start=200.0, dur_s=0.5, track="batcher",
               span_id=1, flow_out=(11, 12), args={"jobs": 2}),
        m.Span(name="job", start=200.1, dur_s=0.2, track="job 0",
               span_id=2, parent_id=1, flow_in=(11,)),
        m.Span(name="job", start=200.2, dur_s=0.3, track="job 1",
               span_id=3, parent_id=1, flow_in=(12,), args={"k": "v"}),
    ]


def _span_log(m):
    """A fresh SpanLog: off, on, flows, the cap and its drop count."""
    log = m.SpanLog(cap=3)
    off = log.add("x", 1.0, 0.5)
    log.enable()
    ids = [log.add("s", 1.0 + i, -0.5 if i == 1 else 0.25, track="t",
                   flow_in=i, flow_out=[i, i + 1], args={"i": i})
           for i in range(5)]
    flows = [log.new_flow(), log.new_flow()]
    snap = [(s.name, s.start, s.dur_s, s.track, s.span_id, s.parent_id,
             s.flow_in, s.flow_out, s.args) for s in log.snapshot()]
    out = (off, ids, flows, snap, log.dropped, len(log))
    log.clear()
    log.disable()
    return out + (len(log), log.dropped, log.add("y", 0.0, 1.0))


def test_span_log_matches_jax():
    assert _span_log(tm) == _span_log(jm)
    assert tm.perf_to_epoch(5.0) - 5.0 == pytest.approx(
        jm.perf_to_epoch(5.0) - 5.0, abs=0.05)


REC = np.zeros((7, bt.state.REC_WIDTH), np.int32)
REC[:5] = np.random.default_rng(3).integers(0, 50, (5, bt.state.REC_WIDTH))
REC[2, bt.state.REC_UNDEC0:bt.state.REC_UNDECQ + 1] = 0      # quiesced
WIT = np.random.default_rng(4).integers(
    0, 3, (5, 2, 3, bt.state.WIT_WIDTH)).astype(np.int32)
WIT[:, :, :, bt.state.WIT_WRITTEN] = 0
WIT[:3, :, :, bt.state.WIT_WRITTEN] = 1
WIT_IDS = (np.array([0, 5]), np.array([1, 2, 9]))


def _exported(m, kind, path):
    reg = m.MetricsRegistry()
    reg.counter("c.one").inc(3)
    reg.gauge("g-two").set(0.5)
    for start, dur in ((50.0, 0.25), (50.5, 1.5)):
        reg.timer("t.host").record(dur, start=start)
    if kind == "jsonl":
        n = m.export_jsonl(path, reg, extra=m.round_history_rows(REC))
        with open(path) as fh:
            lines = [json.loads(ln) for ln in fh]
        assert all(isinstance(ln.pop("ts"), float) for ln in lines)
        return n, lines
    if kind == "prometheus":
        n = m.export_prometheus(path, reg)
    elif kind == "prometheus_prefix":
        n = m.export_prometheus(path, reg, prefix="x_")
    else:
        wit = (WIT, *WIT_IDS) if kind == "chrome_witness" else None
        n = m.export_chrome_trace(path, reg, round_history=REC,
                                  rounds_label="benor N=8 f=2",
                                  witness=wit, spans=_spans(m))
    with open(path) as fh:
        return n, fh.read()


@pytest.mark.parametrize("kind", ["jsonl", "prometheus",
                                  "prometheus_prefix", "chrome",
                                  "chrome_witness"])
def test_exporters_write_the_jax_documents(kind, tmp_path):
    got = _exported(tm, kind, str(tmp_path / "port"))
    want = _exported(jm, kind, str(tmp_path / "jax"))
    assert got == want
    assert got[0] > 3


def test_recorder_rendering_matches_jax():
    for since in (None, 0, 2, 9):
        assert tm.round_history_rows(REC, since) == \
            jm.round_history_rows(REC, since)
    assert tm.round_history_summary(REC) == jm.round_history_summary(REC)
    np.testing.assert_array_equal(tm.executed_rows(torch.from_numpy(REC)),
                                  jm.executed_rows(REC))


def _counts(reg, prefix):
    return {m["name"]: m["value"] for m in reg.snapshot()
            if m["name"].startswith(prefix)}


def _journal_counts(jmod, path):
    """Three bucket records, two of them tampered, then a resume that
    looks each up -> (matches, counters)."""
    pts = [[{"i": i, "mean_k": 1.5 + i}] for i in range(3)]
    j = jmod.SweepJournal(path, label="t")
    for i in range(3):
        j.record_bucket(i, "static", [i], f"fp{i}", 0, {"run_s": 0.5},
                        pts[i])
    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh]
    recs[1]["points"][0]["mean_k"] = 9.0           # payload edited
    recs[2]["pipelined"] = True                    # provenance edited
    with open(path, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in recs)
    r = jmod.SweepJournal(path, resume=True, label="t")
    found = [r.match(f"fp{i}", [i]) is not None for i in range(3)]
    found.append(r.match("fp9", [9]) is not None)
    return found


def test_journal_counters_tick_as_jax(registries, tmp_path):
    treg, jreg = registries
    got = _journal_counts(tjournal, str(tmp_path / "port.jsonl"))
    want = _journal_counts(jjournal, str(tmp_path / "jax.jsonl"))
    assert got == want == [True, False, False, False]
    assert _counts(treg, "sweepscope.") == _counts(jreg, "sweepscope.") == \
        {"sweepscope.journal.buckets": 3.0,
         "sweepscope.journal.tampered": 2.0}


def test_audit_counters_tick_as_jax(registries, monkeypatch):
    """One clean port run's witness and three tampered copies, audited by
    both packages."""
    from benor_tpu_torch.ops import sampling as tsampling
    from benor_tpu_torch.state import WIT_DECIDED, WIT_X
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", 4)
    treg, jreg = registries
    cfg = bt.SimConfig(n_nodes=40, n_faulty=12, delivery="quorum",
                       path="histogram", rule="textbook", max_rounds=16,
                       seed=2, trials=4)
    cfg = cfg.replace(**taudit.default_witness_overrides(4, 40))
    faults = bt.sweep.default_crash_faults(cfg, "cpu")
    state = bt.init_state(cfg, bt.sweep.balanced_inputs(4, 40), faults)
    buf = bt.run_consensus(cfg, state, faults)[-1].numpy()
    bufs = [buf]
    for edit in range(3):
        b = buf.copy()
        if edit == 0:
            b[3, 0, 8, WIT_DECIDED] = 0
        elif edit == 1:
            b[3, 0, 8, WIT_X] = 1 - b[3, 0, 8, WIT_X]
        else:
            b[1:, 2, 10, WIT_DECIDED] = 1
            b[1:, 2, 10, WIT_X] = 2
        bufs.append(b)
    field_names = ("buffer", "trial_ids", "node_ids", "rule", "n_faulty",
                   "n_nodes", "freeze_decided", "faulty", "unanimous",
                   "tally_bound", "partition", "down_crash",
                   "down_recover", "label")
    for b in bufs:
        tb = taudit.WitnessBundle.from_run(cfg, b, faults=faults)
        taudit.audit_witness(tb)
        jaudit.audit_witness(jaudit.WitnessBundle(
            **{f: getattr(tb, f) for f in field_names}))
    got = _counts(treg, "audit.")
    assert got == _counts(jreg, "audit.")
    assert got["audit.runs"] == 4 and got["audit.pass"] == 1
    assert got["audit.fail"] == 3 and got["audit.violations"] >= 3


@prefetch(lambda: [(_jax_heatmap, HEAT_BASE, *HEAT),
                   (_jax_find_cliffs, "partition")])
def test_atlas_counters_tick_as_jax(registries):
    """A 2 x 2 heatmap and the shipped partition search: the port's
    counters equal the JAX package's ticks, read off its documents (rows;
    probes, generations and cliffs)."""
    treg, _ = registries
    tsearch.heatmap_slice(bt.SimConfig(**HEAT_BASE), *HEAT, na=1, nb=1,
                          device="cpu")
    spec = tmanifest._search_specs()["partition"]
    cfg = bt.SimConfig(**spec["cfg"])
    iv = (tmanifest._ones(cfg.trials, cfg.n_nodes)
          if spec["inputs"] == "ones" else None)
    tsearch.find_cliffs(cfg, spec["axis"], coarse=spec["coarse"],
                        initial_values=iv, device="cpu")
    heat = ref(_jax_heatmap, HEAT_BASE, *HEAT)
    search = ref(_jax_find_cliffs, "partition")
    assert _counts(treg, "atlas.") == {
        "atlas.heatmap.probes": float(len(heat["rows"])),
        "atlas.probes": float(len(search["probes"])),
        "atlas.generations": float(len(search["generations"])),
        "atlas.cliffs": float(len(search["cliffs"])),
    }
    assert search["cliffs"]


def test_demotion_counters_count_calls(registries, monkeypatch):
    """Each demoting run_consensus call ticks its counter once (the JAX
    package ticks once a traced build): two calls, two ticks."""
    from benor_tpu_torch.ops import sampling as tsampling
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", 4)
    treg, _ = registries
    for flag in ("_faults_demotion_warned", "_structured_demotion_warned",
                 "_debug_demotion_warned"):
        monkeypatch.setattr(tsim, flag, True)
    monkeypatch.setattr(ttracing, "_SINKS", [lambda *a: None])
    flags = dict(use_pallas_hist=True, use_pallas_round=True)
    cfgs = {
        "sim.demotion.faults": bt.SimConfig(
            n_nodes=16, n_faulty=2, drop_prob=0.1, max_rounds=4, **flags),
        "sim.demotion.structured": bt.SimConfig(
            n_nodes=16, n_faulty=2, topology="ring:4", max_rounds=4,
            **flags),
        "sim.demotion.debug": bt.SimConfig(
            n_nodes=96, n_faulty=24, delivery="quorum", path="histogram",
            debug=True, max_rounds=4, **flags),
    }
    for cfg in cfgs.values():
        for _ in range(2):
            faults = bt.FaultSpec.none(cfg.trials, cfg.n_nodes)
            state = bt.init_state(cfg, bt.sweep.balanced_inputs(
                cfg.trials, cfg.n_nodes), faults)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                bt.run_consensus(cfg, state, faults)
    assert _counts(treg, "sim.demotion.") == {k: 2.0 for k in cfgs}


def test_timed_records_as_jax(registries):
    treg, jreg = registries
    lines = []
    for mod in (ttracing, jtracing):
        with mod.timed("block", sink=lines.append):
            pass
    assert [re.sub(r"[0-9.]+ ms", "<t> ms", ln) for ln in lines] == \
        ["[benor_tpu] block: <t> ms"] * 2
    got, want = treg.snapshot(), jreg.snapshot()
    assert [(m["name"], m["type"], m["count"]) for m in got] == \
        [(m["name"], m["type"], m["count"]) for m in want] == \
        [("block", "timer", 1)]


def test_profile_trace_writes_a_capture(registries, tmp_path):
    treg, _ = registries
    d = str(tmp_path / "prof")
    with ttracing.profile_trace(d) as where:
        torch.ones(64).cumsum(0)
    assert where == d
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(d, files[0])) as fh:
        assert json.load(fh)["traceEvents"]
    assert _counts(treg, "tracing.") == {"tracing.profile_capture": 1.0}
