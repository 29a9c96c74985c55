"""The port's kernelscope (benor_tpu_torch/kernelscope/) against the JAX
package's (benor_tpu/kernelscope/), on the CPU.

At CAPTURE_SCALE (256 x 8 x 12) each dispatch of the packed round (the
fused kernel, the two-kernel pair; the plain versions stand in on the
CPU) gives the JAX ``capture_kernels``'s dispatch, counts mode, rounds,
telemetry off == on, every stage counter and per-tile row, pad waste and
plane passes a round, the geometry's np_total / tiles / tile_nodes /
planes / one_pass and the plane and count terms of the predicted bytes;
the counters also equal the committed KERNEL_BASELINE.json, against which
the port's manifest gates in band.  The report functions and the live
``kernel_telemetry`` records equal the JAX package's, ``compare_kernels``
gives the JAX function's findings on a tamper matrix of the baseline, and
the JAX schema checker (tools/check_metrics_schema.py, loaded by path)
finds in the port's manifest only the predicted-bytes recomputation,
which prices the Pallas kernels' partials by design.  The JAX capture runs
in the worker pool (torch_ref_pool)."""

import copy
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from benor_tpu.kernelscope import gate as jgate
from benor_tpu.kernelscope import report as jreport
from benor_tpu_torch.kernelscope import capture as tcapture
from benor_tpu_torch.kernelscope import gate as tgate
from benor_tpu_torch.kernelscope import report as treport
from benor_tpu_torch.ops import _build, sampling, tally
from benor_tpu_torch.sim import run_consensus
from torch_ref_pool import prefetch, ref, start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_one_pass", "two_kernel")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def baseline():
    with open(os.path.join(ROOT, "KERNEL_BASELINE.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """The port's CPU capture and its kernel_telemetry records."""
    path = str(tmp_path_factory.mktemp("telem") / "t.jsonl")
    doc = tcapture.capture_kernels(device="cpu", telemetry_path=path)
    with open(path) as fh:
        return doc, [json.loads(ln) for ln in fh]


def _jax_capture_kernels():
    import tempfile
    from benor_tpu.kernelscope import capture_kernels
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.jsonl")
        doc = capture_kernels(telemetry_path=path)
        with open(path) as fh:
            return json.loads(json.dumps(doc)), [json.loads(ln)
                                                 for ln in fh]


@pytest.mark.parametrize("name", KERNELS)
@prefetch(lambda name: [(_jax_capture_kernels,)])
def test_kernel_matches_jax(manifest, baseline, name):
    got = manifest[0]["kernels"][name]
    want = ref(_jax_capture_kernels)[0]["kernels"][name]
    for key in ("kernel", "dispatch", "counts_mode", "rounds_executed",
                "bit_equal_off_on", "stages", "pad_waste_frac",
                "plane_hops_per_round"):
        assert got[key] == want[key], key
    assert got["bit_equal_off_on"]
    geo, jgeo = got["geometry"], want["geometry"]
    for key in ("trials", "n_nodes", "np_total", "tiles", "tile_nodes",
                "planes", "one_pass"):
        assert geo[key] == jgeo[key], key
    # the plane and count terms are the JAX package's arithmetic
    t = jgeo["trials"]
    plane = t * jgeo["planes"] * (jgeo["np_total"] // 32) * 4
    assert got["predicted_terms"]["plane"] == plane
    assert got["predicted_terms"]["counts"] == t * 3 * 4
    jpart = jgeo["tiles"] * t * jgeo["partial_cols"] * \
        jgeo["partial_dtype_bytes"]
    assert want["predicted_bytes_per_round"]["proposal"] == \
        plane + jpart + t * 12
    # the port's partial term: one int32 row a trial a stage on the CPU
    assert geo["partial_rows"] == {"proposal": 1, "vote": 1}
    assert got["predicted_terms"]["partial_proposal"] == t * 4 * 4
    assert got["predicted_terms"]["partial_vote"] == t * 5 * 4
    # XLA's cost model has no counterpart: null, and no ratio
    assert got["measured_bytes_per_round"] is got["byte_ratio"] is None
    # the committed baseline's counters, per tile
    for stage in ("proposal", "vote"):
        assert got["stages"][stage] == \
            baseline["kernels"][name]["stages"][stage]


@prefetch(lambda: [(_jax_capture_kernels,)])
def test_envelope_and_pair_match_jax(manifest):
    got = manifest[0]
    want = ref(_jax_capture_kernels)[0]
    for key in ("kind", "schema_version", "platform", "device_kind",
                "interpret", "scale", "telem_columns"):
        assert got[key] == want[key], key
    fvx, jfvx = got["fused_vs_xla"], want["fused_vs_xla"]
    for key in ("rounds_executed", "bit_equal", "counts_mode"):
        assert fvx[key] == jfvx[key], key
    assert fvx["bit_equal"]
    assert fvx["fused_run_bytes"] is fvx["xla_run_bytes"] is \
        fvx["gap_bytes"] is None
    assert abs(sum(fvx["stage_attribution"].values()) - 1) < 1e-5
    assert "torch_version" in got and "torch_version" not in want


@prefetch(lambda: [(_jax_capture_kernels,)])
def test_telemetry_records_match_jax(manifest):
    def clockless(records):      # ``ts`` is append_jsonl's clock
        return [{k: v for k, v in r.items() if k != "ts"} for r in records]

    got = clockless(manifest[1])
    assert got == clockless(ref(_jax_capture_kernels)[1])
    assert [r["kernel"] for r in got] == list(KERNELS)
    blocks = manifest[0]["kernels"]["two_kernel"]["stages"]
    assert treport.telemetry_record("x", "k", blocks, 2, 0.5) == \
        jreport.telemetry_record("x", "k", blocks, 2, 0.5)


def test_report_functions_match_jax():
    rng = np.random.default_rng(17)
    cols = ("active_lanes", "pad_lanes", "sampler_draws", "hist_visits",
            "quorum_passes", "coin_draws", "plane_hops")
    for tiles, rounds in ((1, 3), (4, 2), (7, 0)):
        acc = rng.integers(0, 1000, (2, tiles, 7)).astype(np.int32)
        got = treport.stage_report(acc, cols)
        assert got == jreport.stage_report(acc, cols)
        assert treport.pad_waste_frac(got) == jreport.pad_waste_frac(got)
        assert treport.plane_hops_per_round(got, 8, rounds) == \
            jreport.plane_hops_per_round(got, 8, rounds)
    zero = treport.stage_report(np.zeros((2, 1, 7), np.int32), cols)
    assert treport.pad_waste_frac(zero) is None
    with pytest.raises(ValueError):
        treport.stage_report(np.zeros((3, 1, 7), np.int32), cols)


def _tamper(doc, which):
    new = copy.deepcopy(doc)
    k = new["kernels"]
    if which == "counter_drift":
        k["two_kernel"]["stages"]["vote"]["counters"]["coin_draws"] += 1
    elif which == "dispatch":
        k["fused_one_pass"]["dispatch"] = "two_kernel"
    elif which == "missing":
        del k["two_kernel"]
    elif which == "pad_waste":
        k["fused_one_pass"]["pad_waste_frac"] += 0.05
    elif which == "ratio_3x":
        k["two_kernel"]["byte_ratio"] *= 3
    elif which == "ratio_gone":
        k["fused_one_pass"]["byte_ratio"] = None
    elif which == "diverged":
        new["fused_vs_xla"]["bit_equal"] = False
    elif which == "pair_gone":
        new["fused_vs_xla"] = None
    elif which == "platform":
        new["platform"] = "gpu"
    elif which == "scale":
        new["scale"]["trials"] = 4
    return new


def _findings(mod, new, base):
    try:
        return [f.to_dict() for f in mod.compare_kernels(new, base)]
    except mod.IncomparableKernels as e:
        return ("incomparable", str(e))


@pytest.mark.parametrize("which", (
    "identity", "counter_drift", "dispatch", "missing", "pad_waste",
    "ratio_3x", "ratio_gone", "diverged", "pair_gone", "platform",
    "scale"))
def test_compare_kernels_matches_jax(baseline, which):
    new = _tamper(baseline, which)
    got = _findings(tgate, new, baseline)
    assert got == _findings(jgate, new, baseline)
    assert (got == []) == (which == "identity")


def test_cpu_manifest_gates_in_band(manifest, baseline):
    """The port's CPU manifest against the committed baseline: the
    dispatch, every stage counter and the pad waste gate; the byte ratio
    (XLA's cost model) is left out across the packages, not between two
    port documents."""
    doc = manifest[0]
    assert tgate.compare_kernels(doc, baseline) == []
    drift = copy.deepcopy(doc)
    drift["kernels"]["fused_one_pass"]["stages"]["proposal"]["per_tile"][
        0][0] += 1
    drift["kernels"]["fused_one_pass"]["stages"]["proposal"]["counters"][
        "active_lanes"] += 1
    assert [f.kind for f in tgate.compare_kernels(drift, baseline)] == \
        ["counter-drift"]
    ported = copy.deepcopy(doc)
    ported["kernels"]["two_kernel"]["byte_ratio"] = 0.5
    assert [f.kind for f in tgate.compare_kernels(doc, ported)] == \
        ["byte-ratio-regression"]


def test_schema_checker_names_only_the_partial_pricing(manifest):
    """The JAX checker recomputes the predicted bytes from the Pallas
    kernels' partial geometry (PARTIAL_COLS int16 columns a tile); the
    port prices its own launches' int32 rows, so that recomputation, and
    nothing else, disagrees, once a kernel."""
    schema = _load_tool("check_metrics_schema")
    errors = schema.check_kernel_manifest(manifest[0])
    assert len(errors) == len(KERNELS)
    for name, err in zip(KERNELS, errors):
        assert err.startswith(f"$.kernels.{name}.predicted_bytes_per_round:"
                              ) and "recomputed from geometry" in err


def test_cf_regime_patch_reaches_every_reader_and_restores():
    cfg = tcapture._fused_cfg(256, 8, 12, 0)
    assert not tally.pallas_round_active(cfg)
    old = sampling.EXACT_TABLE_MAX
    with tcapture._cf_regime(cfg):
        assert sampling.EXACT_TABLE_MAX < cfg.quorum
        assert tally.pallas_round_active(cfg)
        assert tally.pallas_stream_active(cfg)
        from benor_tpu_torch import sweep
        assert sweep.quorum_specialized(cfg)
    assert sampling.EXACT_TABLE_MAX == old
    with pytest.raises(ValueError, match="kernel gate"):
        with tcapture._cf_regime(cfg.replace(use_pallas_round=False)):
            pass
    assert sampling.EXACT_TABLE_MAX == old


def test_capture_leaves_later_runs_unchanged(manifest):
    """A capture keeps nothing: a plain run after it equals one before,
    and ``library_events`` does not move (the manifest fixture's capture
    ran before this test; this one adds another)."""
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs
    cfg = tcapture._two_kernel_cfg(96, 4, 12, 3)
    fl = FaultSpec.none(4, 96, device="cpu")
    st = init_state(cfg, balanced_inputs(4, 96), fl)
    before = run_consensus(cfg, st, fl)
    events0 = _build.library_events
    tcapture.capture_kernels(n_nodes=96, trials=4, device="cpu")
    after = run_consensus(cfg, st, fl)
    assert before[0] == after[0]
    for a in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(before[1], a), getattr(after[1], a))
    assert _build.library_events == events0
