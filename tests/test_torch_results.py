"""The science studies of benor_tpu_torch against the JAX package's, on the
CPU: the port's ``generate(presets=False)`` at N = 400 x 4 (the JAX
package's own toy size for it) runs end to end and writes results.json and
RESULTS.md, and every study in it equals the JAX study at the same size,
field for field but the clocks (``seconds``, ``trials_per_sec``), with the
same printed lines and the same witness bundles and repro documents on
disk; the oracle-parity study (the native oracle's rounds-to-decide law
against the simulator's, N = 100) equals the JAX study but its oracle's
message rate; ``faults_curves`` and ``faults_manifest``, ``ks_two_sample``
and the preset rows' ``serve_replay`` documents equal the JAX package's.

The uniform-scheduler studies draw their counts by the CF sampler in both
packages (``EXACT_TABLE_MAX`` lowered to 4), whose draws are exact at these
populations; the exact tables' lgamma rounding is
tests/test_torch_samplers.py's.  The JAX studies run in the worker pool
(torch_ref_pool), one call a study."""

import contextlib
import io
import json
import os
import re
import tempfile

import jax
import numpy as np
import pytest

import benor_tpu_torch as bt
from benor_tpu import results as jresults
from benor_tpu.faults import report as jreport
from benor_tpu.ops import sampling as jsampling
from benor_tpu.serve.jobs import JobSpec
from benor_tpu_torch import results as tresults
from benor_tpu_torch.faults.curves import churn_curve, drop_curve
from benor_tpu_torch.faults import report as treport
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.serve.jobs import JobSpec as TJobSpec
from benor_tpu_torch.sweep import baseline_configs
from torch_ref_pool import prefetch, ref, start

N, T = 400, 4
CF_MAX = 4
CLOCKS = ("seconds", "trials_per_sec", "oracle_msgs_per_sec")
#: generate's key -> (study function, its header line in generate's output)
STUDIES = {
    "balanced_curve": ("balanced_curve", "balanced rounds-vs-f curve:"),
    "margin_sweep": ("margin_sweep", "margin sweep (f=0.40):"),
    "coin_contrast": ("coin_contrast", "coin contrast (adversarial):"),
    "disagreement": ("disagreement_sweep",
                     "disagreement vs adversary strength (f=0.25):"),
    "safety_violation": ("safety_violation",
                         "safety violation under the targeted adversary:"),
    "equivocation": ("equivocation_threshold",
                     "equivocation: the N > 3F bound at scale:"),
    "trajectory": ("trajectory_study",
                   "convergence trajectory (f=0.45, balanced):"),
    "scaling": ("scaling_study",
                "scaling: rounds + throughput vs N (f=0.45, balanced):"),
    "rule_comparison": ("rule_comparison", "decision rule: reference vs "
                        "textbook (f=0.45, balanced):"),
    "weak_coin": ("weak_coin_study", "weak common coin: termination vs eps "
                  "(f=0.40, adversary):"),
    "oracle_parity": ("oracle_parity", "oracle<->scheduler distribution "
                      "parity (N=100):"),
}
WITH_OUT_DIR = ("disagreement", "safety_violation")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool) and drop this module's
    compiled programs when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _normal(rows, out_dir):
    """JSON-exact rows without the clocks, file paths as basenames."""
    def walk(o):
        if isinstance(o, dict):
            return {k: (os.path.basename(v) if k in ("bundle", "repro")
                        else walk(v))
                    for k, v in o.items() if k not in CLOCKS}
        if isinstance(o, list):
            return [walk(v) for v in o]
        return o
    return walk(json.loads(json.dumps(rows)))


def _lines(text, out_dir):
    """Printed lines with the clocks and the output directory masked."""
    text = re.sub(r"[0-9.]+ trials/s", "<rate> trials/s", text)
    return text.replace(out_dir, "<out>").splitlines()


def _files(out_dir):
    """The witness bundles and repro documents a study wrote."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(("witness_", "repro_")):
            with open(os.path.join(out_dir, name)) as fh:
                out[name] = json.load(fh)
    return out


def _jax_study(key, n, trials):
    """One JAX study as generate() runs it -> (rows, files, lines)."""
    fn = getattr(jresults, STUDIES[key][0])
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = CF_MAX
    buf = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(buf):
            kw = {"out_dir": d} if key in WITH_OUT_DIR else {}
            # the oracle study runs at its fixed N = 100 (generate hands it
            # the trials and the seed)
            v = (fn(trials, 0) if key == "oracle_parity"
                 else fn(n, trials, 0, **kw))
            files = _files(d)
            lines = _lines(buf.getvalue(), d)
    finally:
        jsampling.EXACT_TABLE_MAX = old
    if key == "balanced_curve":
        v = [{"f_frac": fr, **p.to_dict()}
             for fr, p in zip(jresults.CURVE_FRACS, v)]
    elif key == "coin_contrast":
        v = {k: [p.to_dict() for p in pts] for k, pts in v.items()}
    return _normal(v, d), files, lines


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The port's generate(presets=False) at N = 400 x 4 on the CPU ->
    (output dict, out_dir, printed text)."""
    out_dir = str(tmp_path_factory.mktemp("results"))
    old = tsampling.EXACT_TABLE_MAX
    tsampling.EXACT_TABLE_MAX = CF_MAX
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = tresults.generate(out_dir=out_dir, n_large=N,
                                    trials_large=T, presets=False,
                                    device="cpu")
    finally:
        tsampling.EXACT_TABLE_MAX = old
    return out, out_dir, buf.getvalue()


def _block(text, out_dir, key):
    """The lines generate printed for one study."""
    lines = _lines(text, out_dir)
    headers = [h for _, h in STUDIES.values()]
    i = lines.index(STUDIES[key][1])
    j = next((k for k in range(i + 1, len(lines))
              if lines[k] in headers
              or lines[k].startswith(("oracle", "results: wrote"))),
             len(lines))
    return lines[i + 1:j]


@pytest.mark.parametrize("key", list(STUDIES))
@prefetch(lambda key: [(_jax_study, key, N, T)])
def test_study_matches_jax(key, generated):
    """One study of the port's generate: its rows in results.json, its
    printed lines, and (the safety studies) the witness bundles and repro
    documents it wrote, against the same JAX study."""
    out, out_dir, text = generated
    with open(os.path.join(out_dir, "results.json")) as fh:
        rows = json.load(fh)[key]
    want_rows, want_files, want_lines = ref(_jax_study, key, N, T)
    assert _normal(rows, out_dir) == want_rows
    assert _normal(out[key], out_dir) == want_rows
    assert _block(text, out_dir, key) == want_lines
    if key in WITH_OUT_DIR:
        files = {k: v for k, v in _files(out_dir).items()
                 if any(str(r.get("witness_audit", {}).get(f, "")).endswith(k)
                        for r in rows for f in ("bundle", "repro"))}
        assert files == want_files and files


def test_generate_end_to_end(generated):
    """Both artifacts, every study's key (the oracle study's with it: g++
    builds the native oracle here), the CPU's meta, and the science
    verdicts the JAX package's own generator test pins at this size."""
    out, out_dir, text = generated
    assert set(out) == {"meta", *STUDIES}
    assert out["meta"] == {"device": "cpu", "platform": "cpu",
                           "n_large": N, "trials_large": T, "seed": 0}
    assert "oracle parity: skipped" not in text
    assert out["oracle_parity"]["order_invariant_decided_runs"] is True
    with open(os.path.join(out_dir, "results.json")) as fh:
        assert _normal(json.load(fh), out_dir) == _normal(out, out_dir)
    sv = out["safety_violation"]
    for row in sv:
        if row["fault_model"] == "equivocate":
            assert row["disagree_frac"] == 1.0
        elif "odd" in row["fault_model"]:
            assert (row["disagree_frac"] == 1.0) is \
                ("N<3F+1" in row["fault_model"]), row
        elif row["f"] == 0 or row["f"] > N // 2:
            assert row["disagree_frac"] == 0.0
        else:
            assert row["disagree_frac"] == 1.0, row
        if row["disagree_frac"] > 0:
            assert row["witness_audit"]["n_violations"] >= 0
    eq = {r["label"]: r for r in out["equivocation"]}
    assert eq["N//3"]["decided_frac"] == 1.0
    assert eq["N//3+1"]["decided_frac"] == 0.0
    rules = {r["rule"]: r for r in out["rule_comparison"]}
    assert rules["reference"]["mean_k"] < rules["textbook"]["mean_k"]
    assert [r["n"] for r in out["scaling"]] == [N]
    with open(os.path.join(out_dir, "RESULTS.md")) as fh:
        md = fh.read()
    assert "N > 3F" in md and "trajectory" in md.lower()


def test_results_markdown_is_the_jax_rendering(generated, tmp_path):
    """RESULTS.md is the JAX package's rendering of the same output, but
    for the command and the auditor it names."""
    out, out_dir, _ = generated
    jresults._write_markdown(str(tmp_path), out)
    with open(tmp_path / "RESULTS.md") as fh:
        want = fh.read()
    with open(os.path.join(out_dir, "RESULTS.md")) as fh:
        got = fh.read()
    want = want.replace("python -m benor_tpu results",
                        "python -m benor_tpu_torch results")
    want = want.replace("(benor_tpu/audit.py)",
                        "(benor_tpu_torch/audit.py)")
    assert got == want


# --- the fault curves and their manifest --------------------------------------

FAULTS_N, FAULTS_T = 64, 4
IDENTITY = {"bit_equal": True, "extra_compiles": 0}
AUDITS = {"crash_recover": {"ok": True, "checks": 12, "violations": 0},
          "partition": {"ok": True, "checks": 9, "violations": 0}}
CURVE_COUNTS = ("drop_compile_count", "churn_compile_count")


def _jax_faults(n, trials):
    curves = jresults.faults_curves(n, trials)
    return curves, jreport.faults_manifest(IDENTITY, curves, AUDITS)


@prefetch(lambda: [(_jax_faults, FAULTS_N, FAULTS_T)])
def test_faults_curves_and_manifest_match_jax():
    """The omission curve (one dynamic bucket) and the churn curve, and the
    faults_manifest assembled from them, its ok verdict included."""
    got = tresults.faults_curves(FAULTS_N, FAULTS_T, device="cpu")
    want, want_manifest = ref(_jax_faults, FAULTS_N, FAULTS_T)
    assert {k: v for k, v in got.items() if k not in CURVE_COUNTS} == \
        {k: v for k, v in want.items() if k not in CURVE_COUNTS}
    assert got["drop_buckets"] == 1
    manifest = treport.faults_manifest(IDENTITY, got, AUDITS)
    assert {k: v for k, v in manifest.items() if k not in CURVE_COUNTS} == \
        {k: v for k, v in want_manifest.items() if k not in CURVE_COUNTS}
    assert manifest["ok"]
    for bad in ({"bit_equal": False, "extra_compiles": 0},
                {"bit_equal": True, "extra_compiles": 1}):
        assert not treport.faults_manifest(bad, got, AUDITS)["ok"]
    assert not treport.faults_manifest(
        IDENTITY, got, {"x": {"ok": False}})["ok"]
    with pytest.raises(ValueError, match="ARMED omission plane"):
        drop_curve(bt.SimConfig(n_nodes=16, n_faulty=2), [0.0, 0.1],
                   device="cpu")
    with pytest.raises(ValueError, match="down lengths >= 1"):
        churn_curve(bt.SimConfig(n_nodes=16, n_faulty=2), [0, 1],
                    device="cpu")


# --- the host helpers ---------------------------------------------------------

KS_SAMPLES = {
    "identical": ([1, 2, 3, 4], [1, 2, 3, 4]),
    "shifted": (list(range(40)), list(range(5, 45))),
    "far": ([0] * 30, [5] * 20),
    "rounds": (np.random.default_rng(1).integers(1, 6, 200).tolist(),
               np.random.default_rng(2).integers(1, 7, 300).tolist()),
}


@pytest.mark.parametrize("name", list(KS_SAMPLES))
def test_ks_two_sample_matches_jax(name):
    """The statistic and the asymptotic p-value on fixed samples (both
    branches of the Kolmogorov series and the lam ~ 0 case)."""
    a, b = KS_SAMPLES[name]
    got = tresults.ks_two_sample(a, b)
    assert got == jresults.ks_two_sample(a, b)
    stats = pytest.importorskip("scipy.stats")
    assert got[0] == pytest.approx(stats.ks_2samp(a, b).statistic)


def test_serve_replay_documents_match_jax():
    """A preset row's ``serve_replay``, the port's
    JobSpec.from_config(cfg).to_dict(), equals the JAX request plane's,
    for every preset and for a recorded and a witnessed config."""
    from benor_tpu.config import SimConfig as JCfg
    import dataclasses
    cfgs = list(baseline_configs().values())
    cfgs += [cfgs[0].replace(record=True),
             cfgs[0].replace(witness_trials=(0,), witness_nodes=2)]
    for cfg in cfgs:
        jcfg = JCfg(**dataclasses.asdict(cfg))
        assert TJobSpec.from_config(cfg).to_dict() == \
            JobSpec.from_config(jcfg).to_dict()


@prefetch(lambda: [(_jax_study, "oracle_parity", N, T)])
def test_device_rule_and_unported_study(monkeypatch):
    """No flags on the CPU (as the JAX package on its CPU); the oracle
    study, called on its own, equals the JAX package's key for key (but
    its oracle's message rate) with the same printed lines."""
    assert tresults._flagship_flags("cpu") == {}
    assert tresults.FLAGSHIP_FLAGS == jresults.FLAGSHIP_FLAGS
    for name in ("CURVE_FRACS", "MARGINS", "STRENGTHS", "WEAK_COIN_EPS"):
        assert getattr(tresults, name) == getattr(jresults, name)
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", CF_MAX)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = tresults.oracle_parity(T, device="cpu")
    want_rows, _, want_lines = ref(_jax_study, "oracle_parity", N, T)
    assert set(got) == set(want_rows) | {"oracle_msgs_per_sec"}
    assert _normal(got, "") == want_rows
    assert _lines(buf.getvalue(), "<none>") == want_lines
