"""``python -m benor_tpu_torch`` against ``python -m benor_tpu``, on the CPU:
``main([...])`` of each ported subcommand (demo with the tpu, express and
native backends, sweep, coins, trace, preset, audit, atlas, replay;
results' argument plumbing) with ``--device cpu`` prints the JAX package's
lines, writes its ``--out`` / ``--audit-out`` / ``--profile-out`` /
``--out-dir`` JSON, its Chrome trace and its ``--metrics-out`` documents
(JSON-lines or Prometheus), and returns its exit code (audit 2 on
violations, atlas 2 on drift, replay 2 on a mismatch and 1 on an
unreadable file).  Clocks and compile counts are masked in the lines and
left out of the JSON (``seconds``, ``trials_per_sec``, ``compile_count``;
a timer's seconds, the trace's host spans' times, the JSON-lines ``ts``):
they differ by design, as do the JAX package's XLA counters (``jax.*``,
``backend.*``), which the port does not keep.  Both registries are emptied
before each call.  ``serve``, ``load``, ``watch`` and the sweep's
heartbeat flags run; each unported subcommand raises naming its ROADMAP
item, and without ``--device cpu`` on a machine with no CUDA device a
subcommand fails instead of running on the CPU, but the event-loop
oracles' demo and ``watch``, which take no device.

The uniform-scheduler runs draw by the CF sampler in both packages
(``EXACT_TABLE_MAX`` lowered to 4).  The JAX side runs in the worker pool
(torch_ref_pool)."""

import contextlib
import io
import json
import os
import re
import tempfile

import jax
import pytest

from benor_tpu import results as jresults
from benor_tpu.__main__ import main as jmain
from benor_tpu.ops import sampling as jsampling
from benor_tpu.utils import metrics as jmetrics
from benor_tpu_torch import results as tresults
from benor_tpu_torch.__main__ import main as tmain
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.utils import metrics as tmetrics
from torch_ref_pool import prefetch, ref, start

CF_MAX = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "ATLAS_BASELINE.json")) as _fh:
    BASELINE_REPROS = {s["name"]: s["cliffs"][0]["repro"]
                       for s in json.load(_fh)["searches"]}
DROPPED = ("seconds", "trials_per_sec", "compile_count")
#: clocks and compile counts in the printed lines
MASKS = ((r'"(seconds|trials_per_sec|compile_count)": [^,\n]+',
          r'"\1": <m>'),
         (r"[0-9.]+ trials/s", "<rate> trials/s"),
         (r"\d+\.\d+s\b", "<t>s"),
         (r"\d+ compiles", "<n> compiles"),
         (r"\d+ compile\(s\)", "<n> compile(s)"),
         (r"wrote \d+ trace events", "wrote <n> trace events"),
         (r"max bucket share \d+%", "max bucket share <p>%"))


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool) and drop this module's
    compiled programs when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _drop(doc):
    if isinstance(doc, dict):
        return {k: _drop(v) for k, v in doc.items() if k not in DROPPED}
    if isinstance(doc, list):
        return [_drop(v) for v in doc]
    return doc


#: the JAX package's XLA metrics, which the port does not keep: the compile
#: and backend-probe counters, and perfscope's AOT lower / compile timers
#: around the batched sweep's bucket executables
XLA_ONLY = ("jax.", "backend.", "perfscope.")


def _trace_doc(doc):
    """A Chrome trace without its clocks (the host spans' times) and the
    XLA counters."""
    events = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "C" and ev["name"].startswith(XLA_ONLY):
            continue
        if ev.get("tid") == "host":
            ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        events.append(ev)
    return dict(doc, traceEvents=events)


def _metrics_doc(path):
    """A --metrics-out document without its clocks and the XLA counters:
    JSON-lines records without ``ts`` and a timer's seconds; Prometheus
    samples with a timer's seconds masked."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".prom"):
        lines = text.splitlines()
        keep = [ln for ln in lines if ln and not
                re.search(r"benor_tpu_(jax|backend|perfscope)_", ln)]
        return [re.sub(r"(_seconds_(total|max)) \S+$", r"\1 <t>", ln)
                for ln in keep]
    recs = []
    for ln in text.splitlines():
        rec = json.loads(ln)
        if rec["name"].startswith(XLA_ONLY):
            continue
        recs.append({k: v for k, v in rec.items()
                     if k not in ("ts", "total_s", "min_s", "max_s")})
    return recs


def _run(main, argv, inputs, sampling, metrics):
    """One CLI call in a fresh directory ``{d}`` holding ``inputs`` (name
    -> JSON document), the metrics registry emptied first -> (exit code,
    masked stdout lines, every JSON file and metrics document the call
    left there, clocks dropped)."""
    old = sampling.EXACT_TABLE_MAX
    sampling.EXACT_TABLE_MAX = CF_MAX
    metrics.REGISTRY.reset()
    buf = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as d:
            for name, doc in inputs.items():
                with open(os.path.join(d, name), "w") as fh:
                    json.dump(doc, fh)
            with contextlib.redirect_stdout(buf):
                rc = main([a.replace("{d}", d) for a in argv])
            text = buf.getvalue().replace(d, "{d}")
            files = {}
            for base, _, names in os.walk(d):
                for name in names:
                    path = os.path.join(base, name)
                    key = os.path.relpath(path, d)
                    if name.startswith("metrics"):
                        files[key] = _metrics_doc(path)
                    elif name.endswith(".json") and name not in inputs:
                        with open(path) as fh:
                            doc = json.load(fh)
                        files[key] = (_trace_doc(doc)
                                      if "traceEvents" in doc
                                      else _drop(doc))
    finally:
        sampling.EXACT_TABLE_MAX = old
        metrics.REGISTRY.reset()
    for pat, rep in MASKS:
        text = re.sub(pat, rep, text)
    return rc, text.splitlines(), files


def _jax_cli(argv, inputs):
    return _run(jmain, argv, inputs, jsampling, jmetrics)


# name -> (argv, input files); argv as the JAX CLI takes it
CASES = {
    "demo": (["demo"], {}),
    "demo_bare": (["-n", "7", "-f", "3", "--max-rounds", "12"], {}),
    "sweep_recorded": (["sweep", "--n", "2100", "--f-values", "200,900",
                        "--trials", "8", "--max-rounds", "16", "--record",
                        "--out", "{d}/points.json"], {}),
    "sweep_batched": (["sweep", "--n", "2100", "--f-values", "100,500,900",
                       "--trials", "8", "--balanced", "--batched",
                       "--journal", "{d}/sweep.jsonl", "--out",
                       "{d}/points.json"], {}),
    "coins": (["coins", "--n", "100", "--f", "40", "--trials", "16",
               "--max-rounds", "16", "--eps", "0.3", "0.9"], {}),
    "preset": (["preset", "n5_faultfree"], {}),
    "audit_clean": (["audit", "--n", "100", "--f", "25", "--trials", "4",
                     "--audit-out", "{d}/bundle.json"], {}),
    "audit_violation": (["audit", "--n", "96", "--f", "4", "--trials", "4",
                         "--scheduler", "targeted", "--balanced",
                         "--max-violations", "2", "--audit-out",
                         "{d}/bundle.json"], {}),
    "audit_unanimous": (["audit", "--n", "64", "--f", "8", "--trials", "4",
                         "--unanimous", "1", "--witness-trials", "1,3",
                         "--witness-nodes", "6"], {}),
    "atlas_quorum": (["atlas", "--searches", "quorum", "--profile-out",
                      "{d}/manifest.json", "--out-dir", "{d}/out"], {}),
    "replay_quorum": (["replay", "{d}/repro.json"],
                      {"repro.json": BASELINE_REPROS["quorum"]}),
    "replay_omission": (["replay", "{d}/repro.json", "--format", "json"],
                        {"repro.json": BASELINE_REPROS["omission"]}),
    "replay_unreadable": (["replay", "{d}/repro.json"],
                          {"repro.json": {"kind": "atlas_manifest"}}),
    # the pins that raised before the oracles, the registry and the trace
    # were ported
    "demo_express": (["demo", "--backend", "express"], {}),
    "demo_native": (["demo", "--backend", "native", "-n", "9", "-f", "4",
                     "--seed", "3"], {}),
    "trace": (["trace", "--n", "100", "--f", "25", "--trials", "4",
               "--max-rounds", "16", "--balanced", "--out",
               "{d}/trace.json", "--metrics-out", "{d}/metrics.jsonl"], {}),
    "sweep_metrics": (["sweep", "--n", "64", "--f-values", "8,20",
                       "--trials", "4", "--max-rounds", "8", "--batched",
                       "--journal", "{d}/sweep.jsonl", "--metrics-out",
                       "{d}/metrics"], {}),
    "coins_metrics": (["coins", "--n", "64", "--f", "20", "--trials", "4",
                       "--max-rounds", "8", "--metrics-out",
                       "{d}/metrics.jsonl"], {}),
    "audit_metrics": (["audit", "--n", "96", "--f", "4", "--trials", "4",
                       "--scheduler", "targeted", "--balanced",
                       "--max-violations", "1", "--metrics-out",
                       "{d}/metrics.prom"], {}),
    "atlas_metrics": (["atlas", "--heatmap", "drop_prob:0.1:0.4,f:8:24",
                       "--coarse", "1", "--profile-out", "{d}/heat.json",
                       "--metrics-out", "{d}/metrics.jsonl"], {}),
}
#: the JAX package's exit codes, pinned: quorum alone has no counterpart
#: for the baseline's omission and partition searches (drift, 2); the
#: baseline's omission repro no longer reproduces bit for bit in either
#: package (ROADMAP), so its replay exits 2
EXIT = {"audit_violation": 2, "atlas_quorum": 2, "replay_omission": 2,
        "replay_unreadable": 1, "audit_metrics": 2}
#: the --metrics-out documents each case must write (coins ticks nothing
#: but the JAX package's XLA counters, so its document holds no record;
#: the JAX package's atlas takes the flag and writes nothing)
METRICS = {"trace": "metrics.jsonl", "sweep_metrics": "metrics",
           "coins_metrics": "metrics.jsonl", "audit_metrics": "metrics.prom"}


@pytest.mark.parametrize("name", list(CASES))
@prefetch(lambda name: [(_jax_cli, *CASES[name])])
def test_cli_matches_jax(name):
    """The lines, the files and the exit code of one invocation."""
    argv, inputs = CASES[name]
    got = _run(tmain, argv + ["--device", "cpu"], inputs, tsampling,
               tmetrics)
    want = ref(_jax_cli, argv, inputs)
    assert got[0] == want[0] == EXIT.get(name, 0)
    assert got[1] == want[1]
    assert got[2] == want[2]
    if name in METRICS:
        assert got[2][METRICS[name]] or name == "coins_metrics"
    if name.startswith("atlas"):
        assert not any(k.startswith("metrics") for k in got[2])
    if any(a.startswith("{d}/") for a in argv[1:]) and \
            not name.startswith("replay"):
        assert got[2]


# --- what is not ported --------------------------------------------------------

UNPORTED = {
    ("lint",): "16",
    ("profile", "--regimes", "traced,sharded"): "15",
    ("scale", "--mesh", "1,2"): "15",
}


@pytest.mark.parametrize("argv", list(UNPORTED))
def test_unported_commands_and_flags_raise(argv):
    """Each raises NotImplementedError naming its ROADMAP item, before any
    device is touched (with or without --device cpu)."""
    item = UNPORTED[argv]
    for extra in ([], ["--device", "cpu"]):
        if argv[0] in ("lint", "scale") and extra:
            continue
        with pytest.raises(NotImplementedError,
                           match=f"Queue A item {item}"):
            tmain(list(argv) + extra)


# --- the request plane and the heartbeat: the pins that raised before
# they were ported, each now a run on --device cpu ------------------------


def _serve_run(tmp_path):
    """`serve --port 0` in its own process: it prints where it listens,
    answers /healthz and a streamed job, and exits 0 on an interrupt."""
    import signal
    import socket
    import subprocess
    import sys
    proc = subprocess.Popen(
        [sys.executable, "-m", "benor_tpu_torch", "serve", "--port", "0",
         "--device", "cpu"], cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        m = re.search(r"listening on http://([0-9.]+):(\d+)", line)
        assert m, line
        body = json.dumps({"n_nodes": 16, "n_faulty": 2, "trials": 4,
                           "max_rounds": 8, "delivery": "all"}).encode()
        resp = b""
        with socket.create_connection((m[1], int(m[2])), timeout=30) as s:
            s.sendall(b"POST /v1/jobs?stream=sse HTTP/1.1\r\nHost: x\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            while b"event: done" not in resp:
                got = s.recv(65536)
                assert got, resp
                resp += got
        assert resp.startswith(b"HTTP/1.1 200") and b"event: result" in resp
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
        proc.stderr.close()
    assert rc == 0


def _load_run(tmp_path):
    """`load --clients 4`: the manifest of four jobs on the CPU, gated
    against the committed 1000-client baseline as not comparable (exit
    0), with the JAX CLI's lines but the clocks."""
    path = str(tmp_path / "m.json")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tmain(["load", "--clients", "4", "--device", "cpu",
                    "--profile-out", path])
    with open(path) as fh:
        doc = json.load(fh)
    assert rc == 0 and doc["kind"] == "serve_manifest"
    assert doc["jobs_completed"] == doc["jobs_submitted"] == 4
    assert out.getvalue().startswith(
        "benor-serve load: cpu (cpu), 4 concurrent clients\n  jobs 4/4 "
        "(errors 0) in ")
    assert "not comparable: manifest drove 4 clients, baseline 1000" in \
        err.getvalue()


def _watch_run(tmp_path):
    """`watch` on a heartbeat file prints the JAX CLI's lines."""
    path = str(tmp_path / "x.jsonl")
    with open(path, "w") as fh:
        for r in (3, 6):
            fh.write(json.dumps({"kind": "heartbeat", "label": "run",
                                 "round": r, "max_rounds": 6,
                                 "decided_frac": r / 6, "progress": r / 6,
                                 "done": r == 6}) + "\n")
    got = []
    for main in (tmain, jmain):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got.append((main(["watch", path, "--timeout", "1"]),
                        out.getvalue()))
    assert got[0] == got[1] and got[0][0] == 0
    assert got[0][1].splitlines()[-1] == \
        "[run] round=6/6 decided=1.000 100% DONE"


def _sweep_run(tmp_path, flags):
    """The sweep with a heartbeat flag: one beat a bucket with --batched
    (registry counter and gauge), none on the per-point path (the JAX
    warning), and no file without a cadence."""
    path = str(tmp_path / "h")
    argv = ["sweep", "--n", "64", "--f-values", "8", "--trials", "8",
            "--device", "cpu"] + [a.replace("{h}", path) for a in flags]
    before = tmetrics.REGISTRY.counter("heartbeat.published").value
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert tmain(argv) == 0
    beats = tmetrics.REGISTRY.counter("heartbeat.published").value - before
    if "--batched" in flags:
        assert beats == 1
        assert tmetrics.REGISTRY.gauge("heartbeat.progress").value == 1.0
    else:
        assert beats == 0 and not os.path.exists(path)


SERVICE = {
    ("serve",): _serve_run,
    ("load", "--clients", "4"): _load_run,
    ("watch", "x.jsonl"): _watch_run,
    ("sweep", "--n", "64", "--f-values", "8", "--batched",
     "--heartbeat-rounds", "2"):
        lambda d: _sweep_run(d, ["--batched", "--heartbeat-rounds", "2"]),
    ("sweep", "--n", "64", "--f-values", "8", "--heartbeat-out", "h"):
        lambda d: _sweep_run(d, ["--heartbeat-out", "{h}"]),
}


@pytest.mark.parametrize("argv", list(SERVICE))
def test_service_commands_and_flags_run(argv, tmp_path):
    """serve, load, watch and the heartbeat flags, each of which raised
    (ROADMAP Queue A item 16) before the request plane and the heartbeat
    were ported, run and give their results."""
    SERVICE[argv](tmp_path)


NO_CUDA = {
    "demo": ["demo"],
    "sweep": ["sweep", "--n", "64", "--f-values", "8", "--out",
              "{d}/p.json"],
    "coins": ["coins"],
    "preset": ["preset", "n5_faultfree"],
    "results": ["results", "--out", "{d}/results"],
    "audit": ["audit", "--audit-out", "{d}/b.json"],
    "atlas": ["atlas", "--profile-out", "{d}/m.json"],
    "replay": ["replay", "{d}/r.json"],
    "profile": ["profile", "--kernels", "--profile-out", "{d}/k.json"],
    "serve": ["serve", "--port", "0"],
    "load": ["load", "--clients", "4", "--profile-out", "{d}/m.json"],
}


@pytest.mark.parametrize("cmd", list(NO_CUDA))
def test_no_cuda_no_fallback(cmd, capsys, tmp_path, monkeypatch):
    """Without --device cpu and with no CUDA device, the subcommand exits 1
    with the device's message and runs nothing on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("{d}", str(tmp_path)) for a in NO_CUDA[cmd]]
    assert tmain(argv) == 1
    err = capsys.readouterr().err
    assert f"benor_tpu_torch {cmd}: " in err and "CUDA" in err
    assert not list(tmp_path.iterdir())


# --- the observatory: the pins that raised before perfscope, kernelscope
# and the rest of sweepscope were ported, each now a run on --device cpu --

OBSERVATORY = {
    "profile_kernels": ["profile", "--kernels", "--profile-out",
                        "{d}/out.json"],
    "sweep_trace": ["sweep", "--n", "64", "--f-values", "8", "--trials",
                    "8", "--batched", "--trace-out", "{d}/out.json"],
    "sweep_manifest": ["sweep", "--n", "64", "--f-values", "8,20",
                       "--trials", "8", "--batched", "--manifest-out",
                       "{d}/out.json"],
}


def _observatory(main, argv):
    """One CLI call writing ``{d}/out.json`` -> (exit code, what the file
    holds but its clocks: a kernel manifest's dispatches and stage
    counters, a trace's sweep spans (name, bucket, points), a sweep
    manifest's scale and buckets)."""
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main([a.replace("{d}", d) for a in argv])
        with open(os.path.join(d, "out.json")) as fh:
            doc = json.load(fh)
    if "traceEvents" in doc:
        held = [(ev["name"], ev["args"].get("bucket"),
                 ev["args"].get("points"), "parent_id" in ev["args"])
                for ev in doc["traceEvents"]
                if ev.get("ph") == "X" and ev["name"].startswith("sweep.")]
    elif doc["kind"] == "kernel_manifest":
        held = {k: (r["dispatch"], r["stages"])
                for k, r in doc["kernels"].items()}
    else:
        held = (doc["kind"], doc["scale"],
                [(b["kind"], b["size"], b["point_indices"])
                 for b in doc["buckets"]])
    return rc, held, err.getvalue()


def _jax_observatory(argv):
    from benor_tpu.utils.metrics import SPANS
    SPANS.clear()
    return _observatory(jmain, argv)[:2]


@pytest.mark.parametrize("name", [n for n in OBSERVATORY
                                  if n.startswith("sweep")])
@prefetch(lambda name: [(_jax_observatory, OBSERVATORY[name])])
def test_sweep_observatory_runs(name):
    """sweep --batched --trace-out / --manifest-out on --device cpu: the
    file's spans or buckets equal the JAX CLI's, one bucket span with its
    four stages a bucket."""
    tmetrics.SPANS.clear()
    try:
        rc, held, err = _observatory(
            tmain, OBSERVATORY[name] + ["--device", "cpu"])
    finally:
        tmetrics.SPANS.disable()
        tmetrics.SPANS.clear()
    assert (rc, held) == ref(_jax_observatory, OBSERVATORY[name])
    assert rc == 0 and "wrote" in err
    if name == "sweep_trace":
        kinds = [n for n, *_ in held if n.startswith("sweep.bucket[")]
        stages = [n for n, _, _, child in held if child]
        assert len(kinds) == 1 and stages == [
            "sweep.prepare", "sweep.compile", "sweep.execute", "sweep.fetch"]
    else:
        assert held[2] == [("static", 1, [0]), ("static", 1, [1])]


def test_profile_kernels_runs_in_band():
    """profile --kernels on --device cpu: the kernel manifest's stage
    counters are the committed KERNEL_BASELINE.json's, and the default
    gate reads it and passes."""
    rc, held, err = _observatory(
        tmain, OBSERVATORY["profile_kernels"] + ["--device", "cpu"])
    with open(os.path.join(ROOT, "KERNEL_BASELINE.json")) as fh:
        base = json.load(fh)
    assert rc == 0 and "kernel gate: in-band" in err
    assert held == {k: (r["dispatch"], r["stages"])
                    for k, r in base["kernels"].items()}


def test_profile_runs_in_band():
    """profile on --device cpu: the four ported regimes with the committed
    PERF_BASELINE.json's rounds, sharded named unported, the packed and
    unfused legs bit-equal, and the default gate passes."""
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        path = os.path.join(d, "p.json")
        rc = tmain(["profile", "--device", "cpu", "--profile-out", path])
        with open(path) as fh:
            doc = json.load(fh)
    with open(os.path.join(ROOT, "PERF_BASELINE.json")) as fh:
        base = json.load(fh)
    assert rc == 0 and "perf gate: in-band" in err.getvalue()
    assert {k: r["rounds_executed"] for k, r in doc["regimes"].items()} == \
        {k: r["rounds_executed"] for k, r in base["regimes"].items()
         if k != "sharded"}
    assert doc["fused_vs_xla"]["bit_equal"]
    assert "sharded: not ported (ROADMAP Queue A item 15)" in \
        out.getvalue()


def test_profile_update_baseline_never_writes_committed(tmp_path, capsys):
    """--update-baseline with no --baseline, or onto a committed baseline,
    refuses (exit 1) and leaves the committed files byte for byte; onto
    another file it writes there."""
    names = ("PERF_BASELINE.json", "KERNEL_BASELINE.json",
             "SWEEP_BASELINE.json")

    def read():
        out = {}
        for name in names:
            with open(os.path.join(ROOT, name), "rb") as fh:
                out[name] = fh.read()
        return out

    before = read()
    for extra in ([], ["--kernels"],
                  ["--baseline", os.path.join(ROOT, "PERF_BASELINE.json")],
                  ["--kernels", "--baseline",
                   os.path.join(ROOT, "KERNEL_BASELINE.json")]):
        assert tmain(["profile", "--device", "cpu", "--update-baseline",
                      *extra]) == 1
        assert "refusing --update-baseline" in capsys.readouterr().err
    assert read() == before
    target = str(tmp_path / "k.json")
    assert tmain(["profile", "--kernels", "--device", "cpu",
                  "--update-baseline", "--baseline", target]) == 0
    with open(target) as fh:
        assert json.load(fh)["kind"] == "kernel_manifest"
    assert read() == before


def test_load_update_baseline_never_writes_committed(tmp_path, capsys):
    """load --update-baseline refuses (exit 1) without --baseline PATH or
    onto SERVE_BASELINE.json, leaving it byte for byte; onto another file
    it writes the manifest there."""
    committed = os.path.join(ROOT, "SERVE_BASELINE.json")
    with open(committed, "rb") as fh:
        before = fh.read()
    for extra in ([], ["--baseline", committed]):
        assert tmain(["load", "--clients", "2", "--device", "cpu",
                      "--update-baseline", *extra]) == 1
        assert "refusing --update-baseline" in capsys.readouterr().err
    target = str(tmp_path / "s.json")
    assert tmain(["load", "--clients", "2", "--device", "cpu",
                  "--update-baseline", "--baseline", target]) == 0
    with open(target) as fh:
        assert json.load(fh)["clients"] == 2
    with open(committed, "rb") as fh:
        assert fh.read() == before


def test_oracle_demo_needs_no_device(capsys, monkeypatch):
    """With no CUDA device and no --device cpu the oracles' demo runs (a
    host program) and prints the JAX demo's lines; the tpu demo exits 1."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain(["demo", "--backend", "express"]) == 0
    got = capsys.readouterr().out
    assert jmain(["demo", "--backend", "express"]) == 0
    assert capsys.readouterr().out == got and "node 9:" in got
    assert tmain(["demo", "--backend", "tpu"]) == 1


def test_results_argument_plumbing(monkeypatch, capsys):
    """`results` hands generate the JAX package's defaults (50,000 x 8 on
    the CPU, with its line; 1M x 32 on the card) and the flags; the
    printed default line is the JAX CLI's."""
    seen = []

    def fake(**kw):
        seen.append(kw)

    monkeypatch.setattr(tresults, "generate", fake)
    monkeypatch.setattr(jresults, "generate", fake)
    assert tmain(["results", "--device", "cpu"]) == 0
    port_line = capsys.readouterr().out
    assert jmain(["results"]) == 0
    assert capsys.readouterr().out == port_line
    assert seen[0] == dict(seen[1], device="cpu")
    assert (seen[0]["n_large"], seen[0]["trials_large"]) == (50_000, 8)
    seen.clear()
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    assert tmain(["results", "--n", "400", "--trials", "4", "--seed", "3",
                  "--no-presets", "--out", "R"]) == 0
    assert seen == [dict(out_dir="R", n_large=400, trials_large=4, seed=3,
                         presets=False, device="cuda")]
    seen.clear()
    assert tmain(["results"]) == 0
    assert (seen[0]["n_large"], seen[0]["trials_large"]) == (1_000_000, 32)
    assert capsys.readouterr().out == ""


def test_atlas_heatmap_cli(tmp_path, capsys):
    """`atlas --heatmap` renders the slice heatmap_slice gives and writes
    its JSON rows and Perfetto counter tracks."""
    from benor_tpu_torch.atlas import render_heatmap, search
    from benor_tpu_torch.config import SimConfig
    prof, trace = str(tmp_path / "h.json"), str(tmp_path / "t.json")
    assert tmain(["atlas", "--heatmap", "drop_prob:0.1:0.4,f:8:24",
                  "--coarse", "1", "--profile-out", prof, "--trace-out",
                  trace, "--device", "cpu"]) == 0
    doc = search.heatmap_slice(
        SimConfig(n_nodes=64, n_faulty=16, trials=8, max_rounds=16,
                  delivery="all", path="histogram", seed=0),
        "drop_prob:0.1:0.4", "f:8:24", na=1, nb=1, device="cpu")
    out = capsys.readouterr().out
    assert render_heatmap(doc) in out
    with open(prof) as fh:
        assert json.load(fh) == json.loads(json.dumps(doc))
    with open(trace) as fh:
        assert len(json.load(fh)["traceEvents"]) == 4
