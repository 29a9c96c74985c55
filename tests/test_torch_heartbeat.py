"""The port's progress heartbeat (benor_tpu_torch/meshscope/heartbeat.py,
``sim.heartbeat_due``, the beats of ``TpuNetwork.start`` and
``sweep.run_points_batched``) and ``watch`` against the JAX package's, on
the CPU.

The publisher's records, gauges and counter equal the JAX publisher's for
the same calls but for the clocks (``rounds_per_sec``, ``eta_s``,
``elapsed_s`` and the file's ``ts``, compared only as present or null).
Heartbeat off and on give the same final state, rounds and recorder on the
sliced network, and the same points on the batched sweep (serial and
pipelined); the records of those runs equal the JAX runs' records field
for field but the clocks.  ``watch --no-follow`` prints the JAX CLI's
lines for one file holding a record of each of the seven kinds, an
unknown kind, a bare value and a torn line.  The JAX runs are computed in
the worker pool (torch_ref_pool)."""

import contextlib
import io
import json
import os
import tempfile

import jax
import numpy as np
import pytest

from benor_tpu.__main__ import main as jmain
from benor_tpu.meshscope import heartbeat as jhb
from benor_tpu.sim import heartbeat_due as jdue
from benor_tpu.utils import metrics as jmetrics
from benor_tpu_torch import sim as tsim
from benor_tpu_torch import sweep as tsweep
from benor_tpu_torch.__main__ import main as tmain
from benor_tpu_torch.api import launch_network
from benor_tpu_torch.config import SimConfig as TCfg
from benor_tpu_torch.meshscope import heartbeat as thb
from benor_tpu_torch.utils import metrics as tmetrics
from torch_ref_pool import prefetch, ref, start

CLOCKS = ("ts", "elapsed_s", "rounds_per_sec", "eta_s")
NET = dict(n=10, f=5, vals=[1, 1, 0, 0, 1, 1, 0, 0, 1, 1])
NET_KW = dict(seed=0, delivery="quorum", max_rounds=12)
#: the count-controlling adversary livelocks every trial to the round cap
#: (a dynamic bucket), and the uniform scheduler's exact-table quorum is a
#: static bucket: two buckets, so two beats
SWEEP_BASE = dict(n_nodes=24, n_faulty=4, trials=8, delivery="quorum",
                  scheduler="adversarial", coin_mode="private",
                  path="histogram", max_rounds=8, seed=3,
                  heartbeat_rounds=2)
SWEEP_POINTS = ((2, "adversarial"), (4, "adversarial"), (4, "uniform"))


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


def _nonclock(rec):
    """A record with its clocks reduced to present / null."""
    return {k: ((v is None) if k in CLOCKS else v) for k, v in rec.items()}


# --- the JAX side (worker pool) ----------------------------------------------


def _jax_net(poll, record, hb):
    """The JAX sliced (or one-shot) network with a heartbeat file ->
    (non-clock records, rounds, states, history)."""
    from benor_tpu.api import launch_network as jlaunch
    faulty = [True] * NET["f"] + [False] * (NET["n"] - NET["f"])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hb.jsonl")
        net = jlaunch(NET["n"], NET["f"], NET["vals"], faulty,
                      backend="tpu", poll_rounds=poll, record=record,
                      heartbeat_rounds=hb, **NET_KW)
        net.heartbeat_path = path
        net.start()
        recs = ([_nonclock(r) for r in jhb.read_records(path)]
                if os.path.exists(path) else [])
    hist = net.get_round_history() if record else None
    return recs, net.rounds_executed, net.get_states(), hist


def _sweep_cfgs(cls, hb):
    base = cls(**{**SWEEP_BASE, "heartbeat_rounds": hb})
    return base, [base.replace(n_faulty=f, scheduler=s)
                  for f, s in SWEEP_POINTS]


def _science(pt):
    d = pt.to_dict()
    for k in ("seconds", "trials_per_sec"):
        d.pop(k)
    return json.loads(json.dumps(d))


def _jax_sweep():
    """The JAX batched sweep with a heartbeat file -> (non-clock records,
    points)."""
    from benor_tpu.config import SimConfig as JCfg
    from benor_tpu.sweep import run_points_batched
    base, cfgs = _sweep_cfgs(JCfg, 2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hb.jsonl")
        cb = run_points_batched(base, cfgs, heartbeat_path=path)
        recs = [_nonclock(r) for r in jhb.read_records(path)]
    return recs, [_science(p) for p in cb.points]


# --- the cadence and the publisher -------------------------------------------


def test_heartbeat_due_matches_jax():
    for h in (0, 1, 2, 3, 5):
        for prev in range(0, 12):
            for nxt in range(prev, 14):
                cfg = TCfg(n_nodes=4, n_faulty=0, heartbeat_rounds=h)
                assert tsim.heartbeat_due(cfg, prev, nxt) == \
                    jdue(cfg, prev, nxt)


def _recorder():
    """A written recorder buffer: rows 0-2 written, the last with 30
    decided, 6 + 3 + 1 undecided of 40 live."""
    from benor_tpu_torch.state import (REC_DECIDED, REC_UNDEC0, REC_UNDEC1,
                                       REC_UNDECQ, REC_WIDTH)
    rec = np.zeros((6, REC_WIDTH), np.int32)
    for r, dec in ((0, 0), (1, 12), (2, 30)):
        rec[r, REC_DECIDED] = dec
        rec[r, REC_UNDEC0] = (40 - dec) - 4
        rec[r, REC_UNDEC1] = 3
        rec[r, REC_UNDECQ] = 1
    rec[2, REC_UNDEC0] = 6
    return rec


def test_publisher_records_gauges_and_file_match_jax(tmp_path):
    """The same calls on both publishers: equal records but the clocks,
    equal gauges and counter ticks, and one file line a beat."""
    import torch
    from benor_tpu.config import SimConfig as JCfg
    rec = _recorder()
    cfg = dict(n_nodes=4, n_faulty=0, max_rounds=10)
    calls = [dict(round_=2, recorder="rec"), dict(round_=4, decided_frac=0.5),
             dict(round_=4), dict(progress=0.25, points_done=1,
                                  points_total=4),
             dict(round_=10, recorder="rec", decided_frac=1.0),
             dict(round_=0), dict(rate=2.0, round_=5)]
    got = {}
    for name, mod, conf, reg_mod, arr in (
            ("t", thb, TCfg, tmetrics, torch.from_numpy(rec)),
            ("j", jhb, JCfg, jmetrics, rec)):
        reg = reg_mod.MetricsRegistry()
        path = str(tmp_path / f"{name}.jsonl")
        pub = mod.HeartbeatPublisher(conf(**cfg), path=path, label="x",
                                     registry=reg)
        recs = [pub.publish(**{k: (arr if v == "rec" else v)
                               for k, v in c.items()}) for c in calls]
        recs.append(pub.close(7, recorder=arr))
        gauges = {k: reg.gauge(f"heartbeat.{k}").value
                  for k in ("round", "decided_frac", "progress")}
        got[name] = ([_nonclock(r) for r in recs],
                     [_nonclock(r) for r in mod.read_heartbeats(path)],
                     gauges, reg.counter("heartbeat.published").value)
    assert got["t"] == got["j"]
    assert got["t"][0][0]["decided_frac"] == 0.75
    assert got["t"][0][-1]["done"] and got["t"][3] == len(calls) + 1


def test_slice_and_sweep_publishers_match_jax():
    """publish_slice_heartbeat fires on the cadence only (registry only,
    a fresh run recognised by its from_round); publish_sweep_heartbeat
    reports points done / total and the bucket index."""
    from benor_tpu.config import SimConfig as JCfg
    got = {}
    for name, mod, conf in (("t", thb, TCfg), ("j", jhb, JCfg)):
        cfg = conf(n_nodes=4, n_faulty=0, max_rounds=10, heartbeat_rounds=2)
        label = "test-slice"
        beats = [mod.publish_slice_heartbeat(cfg, nxt, label=label,
                                             from_round=frm)
                 for frm, nxt in ((1, 2), (2, 4), (4, 5), (5, 8), (1, 3))]
        pub = mod.HeartbeatPublisher(cfg, label="sweep")
        sw = [mod.publish_sweep_heartbeat(cfg, d, 3, publisher=pub,
                                          bucket_index=i)
              for i, d in enumerate((1, 3))]
        got[name] = [None if b is None else _nonclock(b)
                     for b in beats + sw]
    assert got["t"] == got["j"]
    assert [b is None for b in got["t"][:5]] == [True, False, False, False,
                                                 False]
    assert got["t"][-1]["done"] and got["t"][-1]["points_done"] == 3


def test_read_and_tail_records(tmp_path):
    """Mixed kinds, a bare value, a torn tail and a truncation: the same
    records as the JAX reader and tail, the torn line read once it is
    whole, the tail restarted on a shrunk file and stopped at done."""
    path = str(tmp_path / "m.jsonl")
    lines = [json.dumps({"kind": "heartbeat", "round": 1}),
             json.dumps({"kind": "sweep_bucket", "bucket_index": 0}),
             "7", "not json",
             json.dumps({"kind": "heartbeat", "round": 2, "done": True})]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n" + '{"kind": "heart')
    for kinds in (None, ("heartbeat",)):
        assert thb.read_records(path, kinds) == jhb.read_records(path, kinds)
    assert thb.read_heartbeats(path) == jhb.read_heartbeats(path)
    for follow in (False, True):
        got = [list(mod.tail_records(path, poll_s=0.01, timeout_s=0.2,
                                     follow=follow, stop_when_done=False))
               for mod in (thb, jhb)]
        assert got[0] == got[1] and len(got[0]) == 4
    assert [r["round"] for r in thb.tail_heartbeats(
        path, poll_s=0.01, timeout_s=0.2)] == [1, 2]
    # the torn tail completes; a tail that began before sees it once
    off = thb._read_new_records(path, 0, None)[1]
    with open(path, "a") as fh:
        fh.write('beat", "round": 3}\n')
    new, off2 = thb._read_new_records(path, off, None)
    assert [r["round"] for r in new] == [3] and off2 > off
    # a file rewritten shorter than the tail's offset is read from the top
    tail = thb.tail_records(path, poll_s=0.01, timeout_s=0.3,
                            stop_when_done=False, kinds=("heartbeat",))
    assert [next(tail)["round"] for _ in range(3)] == [1, 2, 3]
    with open(path, "w") as fh:
        fh.write(json.dumps({"kind": "heartbeat", "round": 9}) + "\n")
    assert [r["round"] for r in tail] == [9]


# --- the sliced network and the one-shot run ---------------------------------


def _net(poll, record, hb, path=None):
    faulty = [True] * NET["f"] + [False] * (NET["n"] - NET["f"])
    net = launch_network(NET["n"], NET["f"], NET["vals"], faulty,
                         device="cpu", poll_rounds=poll, record=record,
                         heartbeat_rounds=hb, **NET_KW)
    net.heartbeat_path = path
    return net


@prefetch(lambda record: [(_jax_net, 2, record, 2)])
@pytest.mark.parametrize("record", [True, False])
def test_sliced_network_heartbeat_off_on_and_jax(record, tmp_path):
    """poll_rounds=2, heartbeat_rounds=2: on == off in rounds, states and
    recorder; the beats (decided_frac from the recorder, or from the state
    with no recorder) equal the JAX network's, closing with done."""
    path = str(tmp_path / "hb.jsonl")
    nets = [_net(2, record, hb, path if hb else None) for hb in (0, 2)]
    before = tmetrics.REGISTRY.counter("heartbeat.published").value
    for net in nets:
        net.start()
    published = (tmetrics.REGISTRY.counter("heartbeat.published").value
                 - before)
    off, on = nets
    assert off.rounds_executed == on.rounds_executed
    assert off.get_states() == on.get_states()
    for a in ("x", "decided", "k", "killed"):
        assert getattr(off.state, a).equal(getattr(on.state, a))
    if record:
        assert off.get_round_history() == on.get_round_history()
    beats = [_nonclock(r) for r in thb.read_records(path)]
    jrecs, jrounds, jstates, jhist = ref(_jax_net, 2, record, 2)
    assert beats == jrecs and published == len(beats)
    assert on.rounds_executed == jrounds and on.get_states() == jstates
    if record:
        assert on.get_round_history() == jhist
    assert beats[-1]["done"] and beats[-1]["round"] == on.rounds_executed
    assert len(beats) >= 2
    assert all(b["decided_frac"] is not None for b in beats[:-1])


@prefetch(lambda: [(_jax_net, 0, True, 2)])
def test_one_shot_network_publishes_final_beat(tmp_path):
    """poll_rounds=0: one record, the final state, done: true, equal to
    the JAX one-shot run's."""
    path = str(tmp_path / "hb.jsonl")
    net = _net(0, True, 2, path)
    net.start()
    beats = [_nonclock(r) for r in thb.read_records(path)]
    jrecs, jrounds, jstates, _ = ref(_jax_net, 0, True, 2)
    assert beats == jrecs and len(beats) == 1
    assert beats[0]["done"] and beats[0]["round"] == net.rounds_executed
    assert net.get_states() == jstates and net.rounds_executed == jrounds


# --- the batched sweep -------------------------------------------------------


@prefetch(lambda pipeline: [(_jax_sweep,)])
@pytest.mark.parametrize("pipeline", [False, True])
def test_batched_sweep_beats_once_a_bucket(pipeline, tmp_path):
    """One beat a bucket, in bucket order (serial and pipelined); off and
    on give the same points; records and points equal the JAX engine's."""
    path = str(tmp_path / "hb.jsonl")
    curves = {}
    for hb in (0, 2):
        base, cfgs = _sweep_cfgs(TCfg, hb)
        curves[hb] = tsweep.run_points_batched(
            base, cfgs, heartbeat_path=path if hb else None,
            pipeline=pipeline, device="cpu")
    assert [_science(p) for p in curves[0].points] == \
        [_science(p) for p in curves[2].points]
    beats = [_nonclock(r) for r in thb.read_records(path)]
    jrecs, jpoints = ref(_jax_sweep)
    assert beats == jrecs
    assert [_science(p) for p in curves[2].points] == jpoints
    assert len(beats) == curves[2].n_buckets == 2
    assert [(b["bucket_index"], b["points_done"]) for b in beats] == \
        [(0, 2), (1, 3)]
    assert beats[-1]["done"] and tmetrics.REGISTRY.gauge(
        "heartbeat.progress").value == 1.0


# --- watch -------------------------------------------------------------------


def _watch_file(path):
    """One record of each of the seven kinds watch formats, an unknown
    kind, a bare value and a torn last line."""
    recs = [
        {"kind": "heartbeat", "label": "net N=10", "round": 4,
         "max_rounds": 12, "rounds_per_sec": 123.456, "decided_frac": 0.25,
         "eta_s": 0.06, "progress": 0.333333, "done": False},
        {"kind": "sweep_bucket", "label": "sweep", "bucket_index": 1,
         "bucket_kind": "dyn", "point_indices": [0, 2], "prepare_s": 0.01,
         "compile_s": 1.5, "run_s": 0.25, "fetch_s": 0.002,
         "compile_count": 2},
        {"kind": "kernel_telemetry", "label": "kernelscope",
         "kernel": "fused", "rounds": 3, "pad_waste_frac": 0.125,
         "stage_totals": {"vote": {"hist_visits": 4, "quorum_passes": 2,
                                   "coin_draws": 1, "plane_hops": 8}}},
        {"kind": "atlas_probe", "axis": "drop_prob", "generation": 0,
         "value": 0.3, "verdict": "stall", "stall_frac": 0.5,
         "rounds_executed": 16},
        {"kind": "atlas_cliff", "axis": "drop_prob", "generation": 1,
         "lo": 0.3, "hi": 0.32, "width": 0.02, "lo_verdict": "live",
         "hi_verdict": "stall", "converged": True},
        {"kind": "atlas_heatmap", "axis_a": "drop_prob", "axis_b": "f",
         "values_a": [0.0, 0.5], "values_b": [1, 2],
         "rows": [{"a": 0.0, "b": 1, "stall_frac": 0.0},
                  {"a": 0.5, "b": 1, "stall_frac": 1.0},
                  {"a": 0.0, "b": 2, "stall_frac": 0.5},
                  {"a": 0.5, "b": 2, "stall_frac": 0.25}]},
        {"kind": "mystery", "x": 1},
        {"kind": "sweep_done", "label": "sweep", "done": True,
         "points_total": 3, "n_buckets": 2, "buckets_reused": 1,
         "overlap_headroom_s": 0.5},
        {"kind": "heartbeat", "label": "sweep", "round": None,
         "max_rounds": 8, "points_done": 3, "points_total": 3,
         "progress": 1.0, "eta_s": 0.0, "done": True},
    ]
    with open(path, "w") as fh:
        for r in recs[:6]:
            fh.write(json.dumps(r) + "\n")
        fh.write("[1, 2]\n")
        for r in recs[6:]:
            fh.write(json.dumps(r) + "\n")
        fh.write('{"kind": "heartbeat", "ro')


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra", [[], ["--keep-going"],
                                   ["--max-updates", "3"]])
def test_watch_prints_the_jax_lines(extra, tmp_path, monkeypatch):
    """--no-follow on the fixed file: the JAX CLI's lines and exit code,
    with no CUDA device (watch touches none)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "w.jsonl")
    _watch_file(path)
    argv = ["watch", path, "--no-follow", "--timeout", "0.5",
            "--poll", "0.01", *extra]
    got = _cli(tmain, argv)
    assert got == _cli(jmain, argv)
    assert got[0] == 0 and "[net N=10] round=4/12" in got[1]
    if extra == ["--keep-going"]:
        assert got[1].count("DONE") == 2 and '"mystery"' in got[1]


def test_watch_silent_file_exits_1(tmp_path):
    """No records within --timeout: exit 1 and the JAX CLI's message."""
    path = str(tmp_path / "never.jsonl")
    argv = ["watch", path, "--timeout", "0.05", "--poll", "0.01"]
    got = _cli(tmain, argv)
    assert got == _cli(jmain, argv) and got[0] == 1


def test_cli_sweep_heartbeat_then_watch(tmp_path, capsys):
    """sweep --batched --heartbeat-rounds --heartbeat-out writes one beat a
    bucket that watch prints; without --batched it warns as the JAX CLI."""
    path = str(tmp_path / "hb.jsonl")
    argv = ["sweep", "--n", "64", "--f-values", "8,20", "--trials", "8",
            "--device", "cpu", "--heartbeat-rounds", "2"]
    assert tmain(argv + ["--batched", "--heartbeat-out", path]) == 0
    beats = thb.read_heartbeats(path)
    assert [b["points_done"] for b in beats] == [1, 2] and beats[-1]["done"]
    capsys.readouterr()
    assert tmain(["watch", path, "--no-follow", "--timeout", "0.5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[sweep] points=2/2") and "DONE" in lines[-1]
    assert tmain(argv) == 0
    assert "--heartbeat-rounds only publishes on the batched engine" in \
        capsys.readouterr().err
