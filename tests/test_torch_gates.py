"""The port's regression-gate scripts (benor_tpu_torch/tools/) and
perfscope's trajectory checkers against the JAX package's
(tools/check_*_regression.py, benor_tpu/perfscope/baseline.py), on the
CPU.

Both sides are stdlib scripts loaded by file path; each ``main(argv)``
runs in the process on the same documents — every committed baseline
against itself, the regressions the JAX tests inject (a peak-HBM blow-up,
a pad-waste and a counter drift, a coalescing collapse, a queue-wait p99,
a client error, a bucketing collapse, a moved cliff), documents of
another platform or scale, unreadable and missing files, and
``--trajectory`` over the committed BENCH_r*.json / MULTICHIP_r*.json
series and over a copy with one collapsed record — and gives the JAX
script's exit code and its output lines.  One port script runs as a
subprocess, as CI runs it; each loads with torch and JAX blocked.
"""

from __future__ import annotations

import copy
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from benor_tpu.perfscope import baseline as jbaseline
from benor_tpu_torch.perfscope import baseline as tbaseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTOOLS = os.path.join(ROOT, "tools")
TTOOLS = os.path.join(ROOT, "benor_tpu_torch", "tools")
GATES = ("perf", "kernel", "serve", "sweep", "atlas")
BENCH = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json")))
MULTICHIP = sorted(glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPTS = {g: (_load(os.path.join(JTOOLS, f"check_{g}_regression.py"),
                     f"_jax_check_{g}"),
               _load(os.path.join(TTOOLS, f"check_{g}_regression.py"),
                     f"_port_check_{g}"))
           for g in GATES}


def _baseline(gate):
    name = {"perf": "PERF", "kernel": "KERNEL", "serve": "SERVE",
            "sweep": "SWEEP", "atlas": "ATLAS"}[gate]
    with open(os.path.join(ROOT, f"{name}_BASELINE.json")) as fh:
        return json.load(fh)


def _regress_peak(doc):
    """tests/test_perfscope.py's fixture: a 2x peak-HBM regression in
    every regime, the arg + out + temp - alias identity kept."""
    for rep in doc["regimes"].values():
        grown = int(rep["temp_bytes"] + rep["peak_bytes"])
        rep["temp_bytes"] = grown
        rep["peak_bytes"] = (rep["argument_bytes"] + rep["output_bytes"]
                             + grown - rep["alias_bytes"])


def _card_speedup(doc):
    """The card's finding: a real-backend capture whose packed loop reads
    slower than the unfused one (speedup 0.37)."""
    doc["fused_vs_xla"].update(interpret_mode=False, speedup=0.37)


def _nested(keys, value):
    def set_(doc):
        d = doc
        for k in keys[:-1]:
            d = d[k]
        d[keys[-1]] = value(d[keys[-1]]) if callable(value) else value
    return set_


def _cliff_moved(doc):
    cliff = doc["searches"][0]["cliffs"][0]
    width = cliff["hi"] - cliff["lo"]
    cliff["point"] = cliff["hi"] + 5 * width


#: (gate, case) -> (tamper of the baseline or None, extra argv, expected
#: exit code).  A None tamper gates the baseline against itself.
CASES = {
    ("perf", "self"): (None, [], 0),
    ("perf", "self_timing_band"): (None, ["--timing-band", "1000"], 0),
    ("perf", "peak_regression"): (_regress_peak, [], 2),
    ("perf", "bit_equal_false"): (
        _nested(["fused_vs_xla", "bit_equal"], False), [], 2),
    ("perf", "card_speedup"): (_card_speedup, [], 2),
    ("perf", "scale"): (_nested(["scale", "n_nodes"], lambda v: 2 * v),
                        [], 3),
    ("perf", "platform"): (_nested(["platform"], "gpu"), [], 3),
    ("kernel", "self"): (None, [], 0),
    ("kernel", "pad_waste"): (_nested(
        ["kernels", "two_kernel", "pad_waste_frac"], 0.99), [], 2),
    ("kernel", "counter_drift"): (_nested(
        ["kernels", "two_kernel", "stages", "vote", "counters",
         "coin_draws"], lambda v: v + 1), [], 2),
    ("kernel", "platform"): (_nested(["platform"], "gpu"), [], 3),
    ("kernel", "kind"): (_nested(["kind"], "perf_manifest"), [], 3),
    ("serve", "self"): (None, [], 0),
    ("serve", "coalescing_collapse"): (
        lambda d: d.update(jobs_per_launch=1.0,
                           launches=d["jobs_completed"]), [], 2),
    ("serve", "queue_wait_p99"): (_nested(
        ["stages", "queue_wait", "p99"], lambda v: round(v * 3 + 500, 3)),
        [], 2),
    ("serve", "queue_wait_lifted_band"): (_nested(
        ["stages", "queue_wait", "p99"], lambda v: round(v * 3 + 500, 3)),
        ["--stage-band", "10.0"], 0),
    ("serve", "client_error"): (_nested(["errors"], 1), [], 2),
    ("serve", "platform"): (_nested(["platform"], "gpu"), [], 3),
    ("sweep", "self"): (None, [], 0),
    ("sweep", "compile_count"): (_nested(["compile_count"],
                                         lambda v: v + 1), [], 2),
    ("sweep", "platform"): (_nested(["platform"], "gpu"), [], 3),
    ("atlas", "self"): (None, [], 0),
    ("atlas", "cliff_moved"): (_cliff_moved, [], 2),
    ("atlas", "platform"): (_nested(["platform"], "gpu"), [], 3),
}


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


def _both(gate, argv, capsys):
    """(rc, stdout, stderr) of the JAX and the port script on one argv;
    the port's package name reads as the JAX one's, and the lines that
    name a command to run (the two CLIs differ) are left out."""
    jmod, tmod = SCRIPTS[gate]
    got = []
    for mod in (jmod, tmod):
        rc, out, err = _run(mod, argv, capsys)
        err = [e.replace("benor_tpu_torch", "benor_tpu") for e in err
               if "python -m" not in e]
        got.append((rc, out, err))
    return got


@pytest.mark.parametrize("gate,case", list(CASES))
def test_gate_matches_jax(tmp_path, capsys, gate, case):
    tamper, extra, want = CASES[(gate, case)]
    base = os.path.join(tmp_path, "base.json")
    doc = _baseline(gate)
    with open(base, "w") as fh:
        json.dump(doc, fh)
    man = base
    if tamper is not None:
        bad = copy.deepcopy(doc)
        tamper(bad)
        man = os.path.join(tmp_path, "manifest.json")
        with open(man, "w") as fh:
            json.dump(bad, fh)
    jgot, tgot = _both(gate, [man, base] + extra, capsys)
    assert tgot == jgot
    assert tgot[0] == want
    if want == 2:
        assert any("REGRESSION" in line for line in tgot[1] + tgot[2])


@pytest.mark.parametrize("gate", GATES)
def test_unreadable_and_missing_documents(tmp_path, capsys, gate,
                                         monkeypatch):
    """A document that cannot be read exits 3, never 0, as in the JAX
    script; so does a baseline named on the command line that does not
    exist, where the JAX script passes with a note (ROADMAP "Known
    differences").  With no committed baseline at the default path both
    pass with a note unless --strict, which refuses it."""
    good = os.path.join(tmp_path, "good.json")
    with open(good, "w") as fh:
        json.dump(_baseline(gate), fh)
    junk = os.path.join(tmp_path, "junk.json")
    with open(junk, "w") as fh:
        fh.write("{not json")
    absent = os.path.join(tmp_path, "absent.json")
    for argv, want in (([junk, good], 3), ([absent, good], 3),
                       ([good, absent, "--strict"], 3)):
        jgot, tgot = _both(gate, argv, capsys)
        assert tgot == jgot and tgot[0] == want, argv
    jgot, tgot = _both(gate, [good, absent], capsys)
    assert (jgot[0], tgot[0]) == (0, 3) and tgot[1] == jgot[1]
    _, _, err = _run(SCRIPTS[gate][1], [good, absent], capsys)
    assert any(f"no baseline at {absent}" in line for line in err)
    for mod in SCRIPTS[gate]:
        monkeypatch.setattr(mod, "DEFAULT_BASELINE", absent)
    for argv, want in (([good], 0), ([good, "--strict"], 3)):
        jgot, tgot = _both(gate, argv, capsys)
        assert tgot == jgot and tgot[0] == want, argv


def _collapsed_series(tmp_path):
    """The committed BENCH series copied, plus one later record whose
    throughput and kernel ratios collapsed on the newest record's
    platform."""
    for p in BENCH:
        shutil.copy(p, tmp_path)
    with open(BENCH[-1]) as fh:
        rec = json.load(fh)
    head = rec.get("parsed") if isinstance(rec.get("parsed"), dict) \
        else rec
    head["node_rounds_per_sec"] = head["node_rounds_per_sec"] / 100.0
    head["pallas_interpret"] = False
    head["pallas_speedups"] = {k: 1.0 for k in head["pallas_speedups"]}
    collapsed = os.path.join(tmp_path, "BENCH_r99.json")
    with open(collapsed, "w") as fh:
        json.dump(rec, fh)
    with open(os.path.join(tmp_path, "BENCH_r98.json"), "w") as fh:
        json.dump(dict(rec, parsed=dict(
            head, node_rounds_per_sec=head["node_rounds_per_sec"] * 1e4,
            pallas_speedups={k: 9.0 for k in head["pallas_speedups"]})),
                  fh)
    return str(tmp_path / "BENCH_r*.json")


@pytest.mark.parametrize("series", ["committed", "collapsed"])
def test_trajectory_flag_matches_jax(tmp_path, capsys, series):
    """--trajectory walks the bench series and the MULTICHIP series: the
    committed records give notes only (pre-metric, interpret-mode and
    skipped records), a collapsed copy a REGRESSION and exit 2."""
    base = os.path.join(ROOT, "PERF_BASELINE.json")
    argv = [base, base, "--trajectory"]
    if series == "collapsed":
        argv.append(_collapsed_series(tmp_path))
    jgot, tgot = _both("perf", argv, capsys)
    assert tgot == jgot
    assert tgot[0] == (0 if series == "committed" else 2)
    notes = [line for line in tgot[1] if line.startswith("note:")]
    assert notes and all("REGRESSION" not in line for line in
                         (tgot[1] if series == "committed" else []))


@pytest.mark.parametrize("checker", ["check_bench_trajectory",
                                     "check_pallas_speedup_trajectory",
                                     "check_multichip_trajectory"])
def test_trajectory_checkers_match_jax(tmp_path, checker):
    """The three walkers give the JAX ones' findings on the committed
    series and on a copy with one collapsed record."""
    series = MULTICHIP if checker == "check_multichip_trajectory" else BENCH
    got = getattr(tbaseline, checker)(series)
    assert got == getattr(jbaseline, checker)(series)
    assert got and not any(f.startswith("REGRESSION") for f in got)
    if checker == "check_multichip_trajectory":
        ok = [p for p in series if json.load(open(p)).get(
            "scaling_efficiency")]
        rec = json.load(open(ok[-1]))
        rec["scaling_efficiency"] = rec["scaling_efficiency"] / 10.0
        extra = os.path.join(tmp_path, "MULTICHIP_r99.json")
        with open(extra, "w") as fh:
            json.dump(rec, fh)
        series = series + [extra]
    else:
        series = sorted(glob.glob(_collapsed_series(tmp_path)))
    got = getattr(tbaseline, checker)(series)
    assert got == getattr(jbaseline, checker)(series)
    assert any(f.startswith("REGRESSION") for f in got)
    assert tbaseline._headline({"parsed": {"a": 1}}) == {"a": 1}


BLOCKED = ("torch", "numpy", "jax", "benor_tpu", "benor_tpu_torch")


@pytest.mark.parametrize("gate", GATES)
def test_script_loads_with_torch_and_jax_blocked(monkeypatch, gate):
    """Each port script and the gate module it loads by path need the
    standard library alone: with torch, numpy, JAX and both packages
    blocked in sys.modules, the script loads its gate and gates the
    committed baseline against itself."""
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    mod = _load(os.path.join(TTOOLS, f"check_{gate}_regression.py"),
                f"_blocked_check_{gate}")
    loader = getattr(mod, "_load_gate", None) or mod._load_baseline_module
    assert loader().__file__.startswith(os.path.join(ROOT,
                                                     "benor_tpu_torch"))
    base = os.path.join(ROOT, f"{gate.upper()}_BASELINE.json")
    assert mod.main([base, base]) == 0


def test_analysis_loads_with_torch_and_jax_blocked(monkeypatch):
    """The linter itself is stdlib-only: loaded by path with torch, numpy
    and JAX blocked, it lints the port tree (everything but run_lint,
    which ticks the port's metrics registry)."""
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    path = os.path.join(ROOT, "benor_tpu_torch", "analysis")
    spec = importlib.util.spec_from_file_location(
        "_blocked_analysis", os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "_blocked_analysis", pkg)
    spec.loader.exec_module(pkg)
    active, suppressed = pkg.run_rules(
        pkg.Project(os.path.join(ROOT, "benor_tpu_torch")),
        names=["layout-parity", "telem-layout", "layout-outspec"])
    assert active == [] and suppressed == {}
    for name in [n for n in sys.modules
                 if n.startswith("_blocked_analysis.")]:
        del sys.modules[name]


def test_script_runs_as_a_subprocess():
    """The kernel gate as CI runs it: by path, in a process of its own,
    the committed baseline against itself."""
    base = os.path.join(ROOT, "KERNEL_BASELINE.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(TTOOLS, "check_kernel_regression.py"),
         base, base], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "kernel gate: in-band" in proc.stderr
