"""The rest of the port's sweepscope (benor_tpu_torch/sweepscope/: the
manifest, the bucket spans, the gate) against the JAX package's, on the
CPU.

At ``default_sweep_scale`` (9000 x 4 x 12) the standard capture's buckets
(kind, size, point indices), f values and the points' science equal the
JAX ``capture_sweep_manifest``'s, and the stage clocks telescope within
the gate's bands, serial and pipelined.  ``emit_bucket_spans`` gives the
JAX function's span tree for the same stamps; tracing on and off give the
same points and ``library_events``, with one bucket span and its four
stages (one ``restore`` stage for a journal-restored bucket) a bucket.
``compare_sweep`` gives the JAX function's findings on a tamper matrix of
the committed SWEEP_BASELINE.json, and the JAX schema checker accepts the
port's manifest.  The JAX capture runs in the worker pool
(torch_ref_pool)."""

import copy
import importlib.util
import json
import os

import jax
import pytest

from benor_tpu.config import SimConfig as JCfg
from benor_tpu.sweepscope import gate as jgate
from benor_tpu.sweepscope import spans as jspans
from benor_tpu.utils import metrics as jmetrics
from benor_tpu_torch.config import SimConfig as TCfg
from benor_tpu_torch.ops import _build
from benor_tpu_torch.sweep import run_curve_batched
from benor_tpu_torch.sweepscope import gate as tgate
from benor_tpu_torch.sweepscope import manifest as tmanifest
from benor_tpu_torch.sweepscope import spans as tspans
from benor_tpu_torch.utils import metrics as tmetrics
from torch_ref_pool import prefetch, ref, start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def baseline():
    with open(os.path.join(ROOT, "SWEEP_BASELINE.json")) as fh:
        return json.load(fh)


def _science(pt):
    return [pt.n_nodes, pt.n_faulty, pt.trials, pt.coin_mode, pt.scheduler,
            int(pt.rounds_executed), float(pt.decided_frac),
            float(pt.mean_k), float(pt.ones_frac), float(pt.disagree_frac),
            [int(v) for v in pt.k_hist]]


def _shape(doc):
    return [(b["kind"], b["size"], b["point_indices"])
            for b in doc["buckets"]]


@pytest.fixture(scope="module")
def captures():
    """The port's standard capture, pipelined and serial, tracing on for
    the pipelined one."""
    tmetrics.SPANS.clear()
    tmetrics.SPANS.enable()
    try:
        piped = tmanifest.capture_sweep_manifest(pipeline=True,
                                                 device="cpu")
        spans = tmetrics.SPANS.snapshot()
    finally:
        tmetrics.SPANS.disable()
        tmetrics.SPANS.clear()
    serial = tmanifest.capture_sweep_manifest(device="cpu")
    return {"pipelined": piped, "serial": serial, "spans": spans}


def _jax_sweep_manifest():
    from benor_tpu.sweepscope import capture_sweep_manifest
    doc, cb = capture_sweep_manifest(pipeline=True)
    return _shape(doc), doc["scale"], [_science(p) for p in cb.points]


@prefetch(lambda: [(_jax_sweep_manifest,)])
def test_manifest_buckets_and_points_match_jax(captures):
    shape, scale, science = ref(_jax_sweep_manifest)
    for mode in ("pipelined", "serial"):
        doc, cb = captures[mode]
        assert _shape(doc) == shape
        assert doc["scale"] == scale
        assert [_science(p) for p in cb.points] == science
    assert shape == [("dyn", 3, [0, 1, 2]), ("static", 1, [3])]


@pytest.mark.parametrize("mode", ("pipelined", "serial"))
def test_stage_clocks_telescope_in_band(captures, mode):
    doc, cb = captures[mode]
    cov = doc["telescoping"]["coverage"]
    assert tgate.TELESCOPE_MIN <= cov <= tgate.telescope_max(doc)
    assert doc["pipeline"]["pipelined"] == (mode == "pipelined")
    assert doc["compile_count"] == 0 and doc["platform"] == "cpu"
    assert doc["serial_s"] == pytest.approx(
        tgate.serial_s(doc["buckets"]), abs=1e-5)
    assert tgate.compare_sweep(doc, doc) == []
    schema = _load_tool("check_metrics_schema")
    assert schema.check_sweep_manifest(doc) == []
    resumed = copy.copy(cb)
    resumed.bucket_reused = [True] + list(cb.bucket_reused[1:])
    with pytest.raises(ValueError, match="resumed curve"):
        tmanifest.build_sweep_manifest(resumed, TCfg(n_nodes=9000,
                                                     n_faulty=0))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spans(monkeypatch, mod, spans_mod, cfgs, reused):
    """One bucket's span tree from fixed stamps, in a fresh span log, the
    epoch shift off."""
    log = mod.SpanLog().enable()
    monkeypatch.setattr(spans_mod, "SPANS", log)
    monkeypatch.setattr(spans_mod, "perf_to_epoch", lambda t: t)
    stamps = ({"restore": (50.0, 0.25)} if reused else
              {"prepare": (10.0, 0.5), "compile": (10.5, 1.0),
               "execute": (11.5, 2.0), "fetch": (13.5, 0.125)})
    bid = spans_mod.emit_bucket_spans(3, "dyn", [4, 7], cfgs, stamps,
                                      reused=reused)
    return bid, [(s.name, s.start, s.dur_s, s.track, s.span_id,
                  s.parent_id, s.flow_in, s.flow_out, s.args)
                 for s in log.snapshot()]


@pytest.mark.parametrize("reused", (False, True))
def test_bucket_spans_match_jax(monkeypatch, reused):
    got = _spans(monkeypatch, tmetrics, tspans,
                 [TCfg(n_nodes=64, n_faulty=f) for f in (4, 9)], reused)
    want = _spans(monkeypatch, jmetrics, jspans,
                  [JCfg(n_nodes=64, n_faulty=f) for f in (4, 9)], reused)
    assert got == want
    names = [s[0] for s in got[1]]
    assert names == ["sweep.bucket[3]"] + (
        ["sweep.restore"] if reused else
        ["sweep.prepare", "sweep.compile", "sweep.execute", "sweep.fetch"]
    ) + ["sweep.point[4]", "sweep.point[7]"]
    monkeypatch.setattr(tspans, "SPANS", tmetrics.SpanLog())
    assert tspans.emit_bucket_spans(0, "dyn", [0], [], {"prepare": (
        0.0, 1.0)}) is None


def test_tracing_on_off_and_restored_buckets(captures, tmp_path):
    """Tracing on and off give the same points and library_events; every
    bucket has its span and four stages; a journal-restored bucket emits
    one restore stage."""
    _, cb_on = captures["pipelined"]
    spans = captures["spans"]
    base, fs = tmanifest.capture_base_config()
    events0 = _build.library_events
    cb_off = run_curve_batched(base, fs, pipeline=True, device="cpu")
    assert [_science(p) for p in cb_off.points] == \
        [_science(p) for p in cb_on.points]
    assert _build.library_events == events0
    buckets = [s for s in spans if s.name.startswith("sweep.bucket[")]
    assert [s.args["points"] for s in buckets] == [[0, 1, 2], [3]]
    for b in buckets:
        kids = [s.name for s in spans if s.parent_id == b.span_id]
        assert kids == ["sweep.prepare", "sweep.compile", "sweep.execute",
                        "sweep.fetch"]
    journal = str(tmp_path / "j.jsonl")
    small = base.replace(trials=2)
    run_curve_batched(small, fs, journal_path=journal, device="cpu")
    tmetrics.SPANS.clear()
    tmetrics.SPANS.enable()
    try:
        cb = run_curve_batched(small, fs, journal_path=journal,
                               resume=True, device="cpu")
        got = [(s.name, s.args.get("reused")) for s in
               tmetrics.SPANS.snapshot() if s.parent_id is None
               and s.name.startswith("sweep.bucket[")]
        kids = [s.name for s in tmetrics.SPANS.snapshot()
                if s.parent_id is not None]
    finally:
        tmetrics.SPANS.disable()
        tmetrics.SPANS.clear()
    assert all(cb.bucket_reused)
    assert got == [("sweep.bucket[0]", True), ("sweep.bucket[1]", True)]
    assert kids == ["sweep.restore", "sweep.restore"]


def _tamper(doc, which):
    new = copy.deepcopy(doc)
    band = None
    if which == "headroom_grew":
        new["overlap_headroom_frac"] = 0.5
    elif which == "headroom_gone":
        new["overlap_headroom_frac"] = None
    elif which == "compile_creep":
        new["compile_count"] += 2
    elif which == "telescope_broken":
        new["telescoping"]["coverage"] = 0.3
    elif which == "reclaim_low":
        new["pipeline"].update(headroom_model_s=2.0,
                               headroom_reclaimed_frac=0.1)
    elif which == "reclaim_collapse":
        new["pipeline"].update(headroom_model_s=2.0,
                               headroom_reclaimed_frac=0.3)
    elif which == "pipeline_gone":
        new["pipeline"] = None
    elif which == "wall":
        new["wall_s"] *= 3
        band = 2.0
    elif which == "platform":
        new["platform"] = "gpu"
    elif which == "scale":
        new["scale"]["trials"] = 8
    elif which == "schema":
        new["schema_version"] = 1
    return new, band


def _findings(mod, new, base, band):
    try:
        return [f.to_dict() for f in
                mod.compare_sweep(new, base, timing_band=band)]
    except mod.IncomparableSweep as e:
        return ("incomparable", str(e))


@pytest.mark.parametrize("which", (
    "identity", "headroom_grew", "headroom_gone", "compile_creep",
    "telescope_broken", "reclaim_low", "reclaim_collapse", "pipeline_gone",
    "wall", "platform", "scale", "schema"))
def test_compare_sweep_matches_jax(baseline, which):
    new, band = _tamper(baseline, which)
    got = _findings(tgate, new, baseline, band)
    assert got == _findings(jgate, new, baseline, band)
    assert (got == []) == (which == "identity")
    assert tgate.telescope_max(new) == jgate.telescope_max(new)
    if new.get("buckets"):
        assert tgate.headroom_reclaimed_s(new["buckets"], 1.0) == \
            jgate.headroom_reclaimed_s(new["buckets"], 1.0)
