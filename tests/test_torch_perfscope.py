"""The port's perfscope (benor_tpu_torch/perfscope/) against the JAX
package's (benor_tpu/perfscope/), on the CPU.

Each of the four ported regimes, captured at the CPU profile scale
(256 x 8 x 12), gives the JAX ``capture_regime``'s outputs (rounds, x,
decided, k, killed; the batched bucket's summaries too), rounds_executed,
n_faulty and extra; ``sharded`` raises item 15.  The ``fused_vs_xla``
block is bit-equal with the JAX block's dispatch labels, and
``packing_report`` equals the JAX function at every max_rounds in 1..64.
The stdlib comparators give the JAX functions' findings on a tamper
matrix of the committed PERF_BASELINE.json, and the port's CPU manifest
gates in band against it (regimes present, rounds_executed; the fields
measured otherwise left out by name).  A capture leaves later plain runs,
a checkpoint-resumed leg included, and ``library_events`` unchanged.  The
JAX captures run in the worker pool (torch_ref_pool)."""

import copy
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benor_tpu.perfscope import baseline as jbaseline
from benor_tpu_torch.config import SimConfig
from benor_tpu_torch.ops import _build
from benor_tpu_torch.perfscope import baseline as tbaseline
from benor_tpu_torch.perfscope import capture as tcapture
from benor_tpu_torch.perfscope import manifest as tmanifest
from benor_tpu_torch.perfscope import regimes as tregimes
from benor_tpu_torch.sim import run_consensus, run_consensus_slice
from benor_tpu_torch.state import FaultSpec, init_state
from benor_tpu_torch.utils.metrics import REGISTRY
import torch_no_jax
from torch_ref_pool import prefetch, ref, start

# the packages' __init__ export the function ``roofline`` under the
# module's name
jroofline = importlib.import_module("benor_tpu.perfscope.roofline")
troofline = importlib.import_module("benor_tpu_torch.perfscope.roofline")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("traced", "fused_pallas", "sliced", "batched_sweep")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def baseline():
    with open(os.path.join(ROOT, "PERF_BASELINE.json")) as fh:
        return json.load(fh)


def _outputs(name, out):
    """A regime's outputs as numpy: (rounds, x, decided, k, killed), the
    batched bucket's five summaries before its state."""
    if name == "batched_sweep":
        *summ, fin = out
        head = [np.asarray(v) for v in summ]
    else:
        head, fin = [np.asarray(out[0])], out[1]
    return head + [np.asarray(getattr(fin, a))
                   for a in ("x", "decided", "k", "killed")]


def _jax_regime(name):
    from benor_tpu.perfscope.regimes import capture_regime
    rep, out = capture_regime(name)
    return (rep.rounds_executed, rep.n_faulty, rep.extra,
            _outputs(name, out))


def _jax_fused_vs_xla():
    from benor_tpu.perfscope.regimes import capture_fused_vs_xla
    return capture_fused_vs_xla()


@pytest.mark.parametrize("name", PORTED)
@prefetch(lambda name: [(_jax_regime, name)])
def test_regime_matches_jax(name):
    rep, out = tregimes.capture_regime(name, device="cpu")
    rounds, n_faulty, extra, want = ref(_jax_regime, name)
    assert (rep.rounds_executed, rep.n_faulty, rep.extra) == \
        (rounds, n_faulty, extra)
    got = _outputs(name, tuple(
        v.cpu() if isinstance(v, torch.Tensor) else v for v in out))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    # the CPU report: no executable cost model, no allocator peak, no
    # profiler pass; eager torch traces and builds nothing here
    assert (rep.platform, rep.device_kind) == ("cpu", "cpu")
    assert rep.trace_lower_s == 0.0 and rep.backend_compiles == 0
    assert rep.flops is rep.bytes_accessed is rep.peak_bytes is None
    assert rep.device_busy_s is rep.kernel_launches is None
    assert rep.argument_bytes > 0 and rep.output_bytes > 0


def test_sharded_regime_waits_for_item_15():
    with pytest.raises(NotImplementedError, match="Queue A item 15"):
        tregimes.capture_regime("sharded", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 15"):
        tregimes.capture_all(regimes=["traced", "sharded"], device="cpu")
    with pytest.raises(ValueError, match="unknown regime"):
        tregimes.capture_regime("bogus", device="cpu")


@prefetch(lambda: [(_jax_fused_vs_xla,)])
def test_fused_vs_xla_block_matches_jax():
    got = tregimes.capture_fused_vs_xla(device="cpu")
    want = ref(_jax_fused_vs_xla)
    assert got["bit_equal"] and want["bit_equal"]
    assert got["interpret_mode"]
    keys = ("n_nodes", "trials", "max_rounds", "rounds_executed",
            "counts_mode", "one_pass", "baseline_path",
            *jroofline.packing_report(12))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(got) == set(want)


def test_packing_report_matches_jax():
    for mr in range(1, 65):
        assert troofline.packing_report(mr) == \
            jroofline.packing_report(mr), mr
    assert troofline.packing_report(12)["packed_bits_per_node"] == 11


def test_roofline_picks_the_larger_bound():
    h100 = "NVIDIA H100 80GB HBM3"
    r = troofline.roofline(3.35e9, 2e-3, h100, ops=67e9)
    assert (r["bound_s"], r["bound_by"]) == (1e-3, "bytes")
    r = troofline.roofline(3.35e9, 4e-3, h100, ops=2 * 67e9)
    assert (r["bound_s"], r["bound_by"], r["bound_share"]) == \
        (2e-3, "operations", 0.5)
    r = troofline.roofline(1e6, 1e-3, "cpu", ops=1e6)
    assert r["bound_s"] is r["bound_by"] is r["hbm_peak_bytes_per_s"] \
        is None
    assert r["bytes_per_s"] == 1e9 and r["ops_per_s"] == 1e9
    # chip_smoke keeps no copy of the card's peaks or the op model
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.HBM_BYTES_PER_S is troofline.HBM_BYTES_PER_S
    assert chip_smoke.F32_OPS_PER_S is troofline.F32_OPS_PER_S
    assert chip_smoke.ops_needed is troofline.ops_needed


def _tamper(doc, which):
    """(new manifest, timing_band) for one tamper of a baseline."""
    new = copy.deepcopy(doc)
    band = None
    if which == "peak_2x":
        new["regimes"]["traced"]["peak_bytes"] *= 2
    elif which == "flops_down":
        new["regimes"]["fused_pallas"]["flops"] /= 10
    elif which == "bytes_zero":
        new["regimes"]["sliced"]["bytes_accessed"] = 0
    elif which == "missing_regime":
        del new["regimes"]["sharded"]
    elif which == "rounds_drift":
        new["regimes"]["batched_sweep"]["rounds_executed"] += 1
    elif which == "timing":
        new["regimes"]["traced"]["steady_execute_s"] *= 3
        new["regimes"]["sliced"]["compile_s"] /= 3
        band = 1.5
    elif which == "platform":
        new["platform"] = "gpu"
    elif which == "scale":
        new["scale"]["n_nodes"] = 512
    elif which == "schema":
        new["schema_version"] = 1
    return new, band


TAMPERS = ("identity", "peak_2x", "flops_down", "bytes_zero",
           "missing_regime", "rounds_drift", "timing", "platform", "scale",
           "schema")


def _findings(mod, new, base, band):
    try:
        return [r.to_dict() for r in
                mod.compare_manifests(new, base, timing_band=band)]
    except mod.IncomparableManifests as e:
        return ("incomparable", str(e))


@pytest.mark.parametrize("which", TAMPERS)
def test_compare_manifests_matches_jax(baseline, which):
    new, band = _tamper(baseline, which)
    got = _findings(tbaseline, new, baseline, band)
    assert got == _findings(jbaseline, new, baseline, band)
    assert (got == []) == (which == "identity")


FVX_TAMPERS = ("identity", "diverged", "real_slow", "real_fast", "null",
               "missing", "widened")


@pytest.mark.parametrize("which", FVX_TAMPERS)
def test_check_fused_vs_xla_matches_jax(baseline, which):
    doc = copy.deepcopy(baseline)
    fvx = doc["fused_vs_xla"]
    if which == "diverged":
        fvx["bit_equal"] = False
    elif which in ("real_slow", "real_fast"):
        fvx["interpret_mode"] = False
        fvx["speedup"] = 0.9 if which == "real_slow" else 1.2
    elif which == "null":
        doc["fused_vs_xla"] = None
    elif which == "missing":
        del doc["fused_vs_xla"]
    elif which == "widened":
        fvx["packed_bits_per_node"] += 4
    assert tbaseline.check_fused_vs_xla(doc) == \
        jbaseline.check_fused_vs_xla(doc)


def test_cpu_manifest_gates_in_band(baseline):
    """The port's full CPU capture against the committed baseline: the
    four regimes present with the baseline's rounds_executed, sharded
    named unported (not gated), XLA's cost fields null and left out, the
    fused_vs_xla block passing the JAX gate's own check."""
    scale = dict(tregimes.default_profile_scale("cpu"), seed=0)
    reports = tregimes.capture_all(device="cpu", **scale)
    fvx = tregimes.capture_fused_vs_xla(device="cpu", **scale)
    doc = tmanifest.build_manifest(reports, scale, fused_vs_xla=fvx,
                                   device="cpu")
    assert list(doc["regimes"]) == list(PORTED)
    assert doc["unported_regimes"] == {"sharded": "ROADMAP Queue A item 15"}
    assert tmanifest.missing_regimes(doc) == []
    for name in PORTED:
        assert doc["regimes"][name]["rounds_executed"] == \
            baseline["regimes"][name]["rounds_executed"]
    assert tbaseline.compare_manifests(doc, baseline) == []
    assert [f for f in tbaseline.check_fused_vs_xla(doc)
            if f.startswith("REGRESSION")] == []
    # the same document with a regime dropped or its rounds moved fails
    short = copy.deepcopy(doc)
    del short["regimes"]["sliced"]
    assert tmanifest.missing_regimes(short) == ["sliced"]
    assert [r.metric for r in
            tbaseline.compare_manifests(short, baseline)] == ["regime"]
    drift = copy.deepcopy(doc)
    drift["regimes"]["traced"]["rounds_executed"] += 1
    assert [r.metric for r in
            tbaseline.compare_manifests(drift, baseline)] == \
        ["rounds_executed"]
    # two port documents compare on every field, as in the JAX package
    bigger = copy.deepcopy(doc)
    bigger["regimes"]["traced"]["argument_bytes"] *= 2
    assert [r.metric for r in
            tbaseline.compare_manifests(bigger, doc)] == ["argument_bytes"]


def test_capture_leaves_plain_runs_unchanged(tmp_path):
    """Profiling off is bit-identical: a capture runs the code an
    unprofiled run runs and keeps nothing, so the plain runs after it
    (a checkpoint-resumed slice included) equal the ones before, and
    ``library_events`` does not move."""
    from benor_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from benor_tpu_torch.utils.tracing import profile_trace

    n, f = 30, 10
    cfg = SimConfig(n_nodes=n, n_faulty=f, trials=6, delivery="quorum",
                    scheduler="uniform", path="histogram", max_rounds=24,
                    seed=6)
    faults = FaultSpec.from_faulty_list(cfg, [True] * f + [False] * (n - f),
                                        device="cpu")
    state = init_state(cfg, [1] * (f + 10) + [0] * 10, faults)
    events0 = _build.library_events
    r_full, fin_full = run_consensus(cfg, state, faults)
    assert r_full >= 3

    r_mid, mid = run_consensus(cfg.replace(max_rounds=2), state, faults)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, cfg, mid, faults, next_round=r_mid + 1)
    cfg2, st2, fl2, next_round, _ = load_checkpoint(path, device="cpu")
    bounds = (next_round, cfg.max_rounds + 2)

    def resume():
        return run_consensus_slice(cfg2, st2, fl2, *bounds)

    def same(a, b):
        return a[0] == b[0] and all(
            torch.equal(getattr(a[1], x), getattr(b[1], x))
            for x in ("x", "decided", "k", "killed"))

    plain = resume()
    assert plain[0] - 1 == r_full and same((r_full, plain[1]),
                                           (r_full, fin_full))
    timer = REGISTRY.timer("perfscope.test.resume.first_execute")
    n_ev = len(timer.events)
    cap = tcapture.capture_stages("test.resume", resume, (st2, fl2), "cpu")
    assert same(cap.out, plain) and len(timer.events) == n_ev + 1
    assert cap.peak_bytes is None and cap.profile is None
    tregimes.capture_all(device="cpu")
    with profile_trace(str(tmp_path / "tb")):
        assert same(resume(), plain)
    assert same(run_consensus(cfg, state, faults), (r_full, fin_full))
    assert _build.library_events == events0


torch_no_jax.script("observatory", """
    import benor_tpu_torch.perfscope, benor_tpu_torch.kernelscope
    import benor_tpu_torch.sweepscope
    import benor_tpu_torch.perfscope.regimes
    import benor_tpu_torch.kernelscope.capture
    import benor_tpu_torch.sweepscope.manifest
    print(loaded("jax", "jaxlib", "benor_tpu"))
""")


def test_observatory_imports_no_jax():
    """perfscope, kernelscope and sweepscope (their captures included)
    load no JAX module and nothing of the JAX package (in the shared
    child process where JAX is unimportable, tests/torch_no_jax.py)."""
    out, error = torch_no_jax.result("observatory")
    assert error == "", error
    assert out.strip() == "[]"


@pytest.mark.parametrize("path", ("perfscope/baseline.py",
                                  "kernelscope/gate.py",
                                  "sweepscope/gate.py",
                                  "serve/gate.py",
                                  "atlas/gate.py",
                                  "analysis",
                                  "tools/check_perf_regression.py",
                                  "tools/check_kernel_regression.py",
                                  "tools/check_serve_regression.py",
                                  "tools/check_sweep_regression.py",
                                  "tools/check_atlas_regression.py"))
def test_gate_loads_by_path_with_stdlib_alone(path):
    """The gates, the linter (analysis/, a package, which then lints
    itself) and the gate scripts (each with the gate module it loads by
    path) load by file path, as a CI step loads them, with the standard
    library alone: a ``sys.meta_path`` finder records every attempt to
    import torch, numpy, JAX or either package and refuses it, so a
    guarded optional import shows as well as a loaded module."""
    code = f"""
import importlib.util, os, sys
BLOCKED = ("torch", "numpy", "jax", "jaxlib", "benor_tpu",
           "benor_tpu_torch")
attempted = set()


class Blocker:
    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            attempted.add(name)
            raise ModuleNotFoundError(f"{{name}} is blocked", name=name)
        return None


sys.meta_path.insert(0, Blocker)
p = {os.path.join(ROOT, 'benor_tpu_torch', path)!r}
pkg = os.path.isdir(p)
spec = importlib.util.spec_from_file_location(
    "gate", os.path.join(p, "__init__.py") if pkg else p,
    submodule_search_locations=[p] if pkg else None)
mod = importlib.util.module_from_spec(spec)
sys.modules["gate"] = mod
spec.loader.exec_module(mod)
load = getattr(mod, "_load_gate", None) or getattr(
    mod, "_load_baseline_module", None)
if load:
    load()
if pkg:
    mod.run_rules(mod.Project(p), names=["broad-except"])
print(sorted({{m for m in list(sys.modules) + sorted(attempted)
              if m.split(".")[0] in BLOCKED}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
