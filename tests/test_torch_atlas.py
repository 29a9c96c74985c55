"""The phase atlas of benor_tpu_torch against the JAX package's, on the CPU:
the axis grammar and its refusals, the quorum capture with its forensics
(the witness-armed audit and the shrunk repro of each cliff), the
omission and partition searches (their cliffs at [0.3075, 0.32] and
[12, 13] today), the three repros of ATLAS_BASELINE.json replayed, a
capture's journal cut after its first generation and resumed (the
port's journal and the JAX package's), a 2 x 2 heatmap with its render
and export, and the cliff-drift gate's findings.

Documents are compared whole, but for ``compile_count`` (a generation's,
a cliff's, a search's, the manifest's): in the port it counts the kernel
library's builds and loads, 0 on the CPU, where the JAX package counts
its executables.  The JAX side of a capture, a search, a replay and the
heatmap runs in the worker pool (torch_ref_pool); the grammar and the
gate are stdlib and run here.  The omission and partition searches run
without forensics on both sides (their forensics are chip_smoke.py's)."""

import copy
import dataclasses
import json
import os
import tempfile

import jax
import pytest

import benor_tpu_torch as bt
from benor_tpu.atlas import gate as jgate
from benor_tpu.atlas import manifest as jmanifest
from benor_tpu.atlas import repro as jrepro
from benor_tpu.atlas import scenario as jscenario
from benor_tpu.atlas import search as jsearch
from benor_tpu.atlas import render_heatmap as j_render
from benor_tpu.config import SimConfig as JCfg
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.atlas import gate as tgate
from benor_tpu_torch.atlas import manifest as tmanifest
from benor_tpu_torch.atlas import repro as trepro
from benor_tpu_torch.atlas import scenario as tscenario
from benor_tpu_torch.atlas import search as tsearch
from benor_tpu_torch.atlas import render_heatmap as t_render
from torch_ref_pool import prefetch, ref, start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "ATLAS_BASELINE.json")) as _fh:
    BASELINE = json.load(_fh)
#: where the current JAX package (and the port) put the two cliffs the
#: searches refine without forensics; the baseline's omission bracket,
#: [0.295, 0.3075], is an older capture's (in band, ROADMAP)
CLIFFS = {"omission": [(0.3075, 0.32)], "partition": [(12.0, 13.0)]}


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool) and drop this module's
    compiled programs when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _drop(doc, keys=("compile_count",)):
    """A document without the fields that differ by design."""
    if isinstance(doc, dict):
        return {k: _drop(v, keys) for k, v in doc.items() if k not in keys}
    if isinstance(doc, list):
        return [_drop(v, keys) for v in doc]
    return doc


def _atlas_records(lines):
    """A journal's atlas records (probes, cliffs) without their stamps."""
    out = []
    for ln in lines:
        rec = json.loads(ln)
        if rec.get("kind", "").startswith("atlas_"):
            rec.pop("ts")
            out.append(rec)
    return out


# --- the axis grammar -------------------------------------------------------

AXES = ("drop_prob:0.02:0.42:0.02", "drop_prob:0:0.5", "f:1:12:1", "f:1:12",
        "heal_round:2:18:1", "recovery_down:1:6", "topology_degree:2:10:1",
        "committee_size:2:16", "f:1:12:0.5",
        # refusals
        "bogus:1:2", "f:1", "f:a:b", "f:3:3", "drop_prob:0:1:-1",
        "f:1.5:3", "drop_prob:0.1:0.2:0.3:4", "")
BASES = (dict(n_nodes=64, n_faulty=16, trials=2, max_rounds=16,
              delivery="all", path="histogram"),
         dict(n_nodes=64, n_faulty=4, trials=2, max_rounds=16,
              committee_cap=4, committee_count=2, committee_size=4))


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("spec", AXES)
def test_parse_axis_matches_jax(spec):
    """Every axis kind and refusal: the parsed axis, its grid, bisection
    midpoints, snapping and the config a probe realizes (or the same
    ValueError), as the JAX package gives them."""
    got = _outcome(lambda: tscenario.parse_axis(spec))
    want = _outcome(lambda: jscenario.parse_axis(spec))
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got[1] == want[1]
        return
    ta, ja = got[1], want[1]
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.to_dict() == ja.to_dict()
    for coarse in (1, 4, 7):
        assert ta.grid(coarse) == ja.grid(coarse)
    for lo, hi in ((ta.lo, ta.hi), (ta.lo, ta.lo + ta.tol),
                   (ta.lo, (ta.lo + ta.hi) / 3)):
        assert ta.midpoint(lo, hi) == ja.midpoint(lo, hi)
        assert ta.converged(lo, hi) == ja.converged(lo, hi)
    for base in BASES:
        for v in ta.grid(4):
            g = _outcome(lambda: dataclasses.asdict(
                ta.apply(bt.SimConfig(**base), v)))
            w = _outcome(lambda: dataclasses.asdict(
                ja.apply(JCfg(**base), v)))
            assert g == w


# --- captures and searches ---------------------------------------------------

def _jax_capture(searches, forensics):
    """JAX's capture with a journal -> (manifest, journal lines)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "atlas.jsonl")
        doc = jmanifest.capture_atlas(searches, forensics=forensics,
                                      journal_path=path)
        with open(path) as fh:
            return doc, fh.readlines()


def _jax_find_cliffs(name):
    """JAX's search of one shipped spec, forensics off -> its document."""
    spec = jmanifest._search_specs()[name]
    cfg = JCfg(**spec["cfg"])
    iv = (jmanifest._ones(cfg.trials, cfg.n_nodes)
          if spec["inputs"] == "ones" else None)
    return jsearch.find_cliffs(cfg, spec["axis"], coarse=spec["coarse"],
                               initial_values=iv).to_dict()


QUORUM = (_jax_capture, ("quorum",), True)


@pytest.fixture(scope="module")
def quorum_capture(tmp_path_factory):
    """The port's quorum capture with forensics, journaled -> (manifest,
    journal path)."""
    path = str(tmp_path_factory.mktemp("atlas") / "atlas.jsonl")
    doc = tmanifest.capture_atlas(("quorum",), forensics=True,
                                  journal_path=path, device="cpu")
    return doc, path


@prefetch(lambda: [QUORUM])
def test_quorum_capture_matches_jax(quorum_capture):
    """The whole manifest: probes, generations' points and buckets, the
    cliff, its audit verdict, the shrunk repro (digest included) and its
    replay, the platform; the journal's atlas records; the journal's
    probe count."""
    doc, path = quorum_capture
    want, want_lines = ref(*QUORUM)
    assert _drop(doc) == _drop(want)
    assert (doc["platform"], doc["device_kind"]) == ("cpu", "cpu")
    cliff = doc["searches"][0]["cliffs"][0]
    assert (cliff["lo"], cliff["hi"]) == (7.0, 8.0)
    assert cliff["safety"]["audit_ok"] and cliff["repro_reproduced"]
    assert cliff["repro"]["digest"] == tgate.repro_digest(cliff["repro"])
    with open(path) as fh:
        assert _atlas_records(fh.readlines()) == _atlas_records(want_lines)
    assert tmanifest.journal_parity(doc, path)["parity"]


@pytest.mark.parametrize("name", list(CLIFFS))
@prefetch(lambda name: [(_jax_find_cliffs, name)])
def test_find_cliffs_matches_jax(name):
    """The omission (one dynamic bucket a generation) and partition (a
    static bucket a heal round) searches, probe for probe."""
    spec = tmanifest._search_specs()[name]
    cfg = bt.SimConfig(**spec["cfg"])
    iv = (tmanifest._ones(cfg.trials, cfg.n_nodes)
          if spec["inputs"] == "ones" else None)
    got = tsearch.find_cliffs(cfg, spec["axis"], coarse=spec["coarse"],
                              initial_values=iv, device="cpu").to_dict()
    assert _drop(got) == _drop(ref(_jax_find_cliffs, name))
    assert [(c["lo"], c["hi"]) for c in got["cliffs"]] == CLIFFS[name]


def test_cliffs_gate_in_band_against_the_baseline():
    """The two cliffs found above, as a manifest, are in band of the
    committed baseline's (the omission point 0.31375 inside [0.2825,
    0.32])."""
    base = {s["name"]: s for s in BASELINE["searches"]}
    for name, brackets in CLIFFS.items():
        (lo, hi), = brackets
        bc = base[name]["cliffs"][0]
        width = bc["hi"] - bc["lo"]
        assert bc["lo"] - width <= (lo + hi) / 2 <= bc["hi"] + width


# --- replays --------------------------------------------------------------

def _jax_replay(doc):
    return jrepro.replay_repro(doc)


BASELINE_REPROS = {s["name"]: s["cliffs"][0]["repro"]
                   for s in BASELINE["searches"]}


@pytest.mark.parametrize("name", list(BASELINE_REPROS))
@prefetch(lambda name: [(_jax_replay, BASELINE_REPROS[name])])
def test_baseline_repros_replay(name):
    """Each repro of ATLAS_BASELINE.json replays on the port as on the
    JAX package: the digest recomputes, the verdict side is the recorded
    one.  The partition and quorum repros reproduce bit for bit; the
    omission repro was recorded by an older capture, and today the JAX
    package and the port both measure decided_frac 0.5 where it recorded
    0.25, so it replays the same way in both and not bit for bit."""
    doc = BASELINE_REPROS[name]
    got = trepro.replay_repro(doc, "cpu")
    assert got == ref(_jax_replay, doc)
    assert got["digest_ok"]
    assert got["verdict"]["verdict"] == doc["verdict"]["verdict"]
    assert got["ok"] is (name != "omission")


def test_repro_documents_round_trip(tmp_path):
    """save / load of a repro document, and the refusal of another kind."""
    doc = BASELINE_REPROS["quorum"]
    path = str(tmp_path / "repro.json")
    trepro.save_repro(path, doc)
    assert trepro.load_repro(path) == jrepro.load_repro(path) == doc
    with open(path, "w") as fh:
        json.dump({"kind": "atlas_manifest"}, fh)
    with pytest.raises(ValueError, match="not an atlas_repro"):
        trepro.load_repro(path)
    cfg = trepro._cfg_from_doc(doc["config"])
    assert trepro._cfg_to_doc(cfg) == doc["config"]


# --- resume -------------------------------------------------------------------

def _cut_after_first_generation(lines):
    """The journal's lines through the last record of generation 0."""
    last = max(i for i, ln in enumerate(lines)
               if json.loads(ln).get("kind") == "atlas_probe"
               and json.loads(ln)["generation"] == 0)
    return lines[:last + 1]


@pytest.mark.parametrize("writer", ["port", "jax"])
@prefetch(lambda writer: [QUORUM])
def test_cut_journal_resumes_to_the_same_document(writer, quorum_capture,
                                                  tmp_path):
    """A capture killed after its first generation and resumed: the first
    generation's bucket comes back from the journal (the port's journal or
    the JAX package's), the rest runs, and the manifest is the
    uninterrupted one but for the restored-bucket counts."""
    doc, path = quorum_capture
    if writer == "port":
        with open(path) as fh:
            lines = fh.readlines()
    else:
        lines = ref(*QUORUM)[1]
    cut = str(tmp_path / "cut.jsonl")
    with open(cut, "w") as fh:
        fh.writelines(_cut_after_first_generation(lines))
    resumed = tmanifest.capture_atlas(("quorum",), forensics=True,
                                      journal_path=cut, resume=True,
                                      device="cpu")
    keys = ("compile_count", "buckets_reused")
    assert _drop(resumed, keys) == _drop(doc, keys)
    gens = resumed["searches"][0]["generations"]
    assert gens[0]["buckets_reused"] == gens[0]["n_buckets"]
    assert all(g["buckets_reused"] == 0 for g in gens[1:])


# --- the heatmap ---------------------------------------------------------------

HEAT_BASE = dict(n_nodes=64, n_faulty=16, trials=8, max_rounds=16,
                 delivery="all", path="histogram", seed=0)
HEAT = ("drop_prob:0.1:0.4", "f:8:24")


def _jax_heatmap(base, spec_a, spec_b):
    return jsearch.heatmap_slice(JCfg(**base), spec_a, spec_b, na=1, nb=1)


@prefetch(lambda: [(_jax_heatmap, HEAT_BASE, *HEAT)])
def test_heatmap_matches_jax(tmp_path):
    """A 2 x 2 slice in one batched call: the rows, the buckets, the
    rendering and the two exports."""
    got = tsearch.heatmap_slice(bt.SimConfig(**HEAT_BASE), *HEAT, na=1,
                                nb=1, device="cpu")
    want = ref(_jax_heatmap, HEAT_BASE, *HEAT)
    assert _drop(got) == _drop(want)
    assert len(got["rows"]) == 4 and got["n_buckets"] == 1
    for metric in ("stall_frac", "rounds_executed"):
        assert t_render(got, metric) == j_render(want, metric)
    paths = {}
    for who, export, doc in (("port", tsearch.export_heatmap, got),
                             ("jax", jsearch.export_heatmap, want)):
        paths[who] = (str(tmp_path / f"{who}.json"),
                      str(tmp_path / f"{who}_trace.json"))
        export(_drop(doc), *paths[who])
    for a, b in zip(paths["port"], paths["jax"]):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()


# --- the gate --------------------------------------------------------------------

def _variants():
    """Manifests against the baseline: itself, a moved cliff, a vanished
    one, a stale or edited repro, a missing search, another platform,
    another scale, another kind."""
    out = {"same": copy.deepcopy(BASELINE)}
    m = copy.deepcopy(BASELINE)
    m["searches"][0]["cliffs"][0].update(lo=0.36, hi=0.37)
    out["moved"] = m
    m = copy.deepcopy(BASELINE)
    m["searches"][1]["cliffs"] = []
    out["vanished"] = m
    m = copy.deepcopy(BASELINE)
    m["searches"][2]["cliffs"][0]["repro_reproduced"] = False
    out["stale"] = m
    m = copy.deepcopy(BASELINE)
    m["searches"][2]["cliffs"][0]["repro"]["verdict"]["mean_k"] = 9.0
    out["edited"] = m
    m = copy.deepcopy(BASELINE)
    m["searches"][1]["cliffs"][0]["repro"] = None
    out["no_repro"] = m
    m = copy.deepcopy(BASELINE)
    m["searches"] = m["searches"][:1]
    out["missing"] = m
    m = copy.deepcopy(BASELINE)
    m["platform"], m["device_kind"] = "gpu", "NVIDIA H100 80GB HBM3"
    out["platform"] = m
    m = copy.deepcopy(BASELINE)
    m["scale"] = {"factor": 2.0}
    out["scale"] = m
    m = copy.deepcopy(BASELINE)
    m["kind"] = "sweep_manifest"
    out["kind"] = m
    m = copy.deepcopy(BASELINE)
    m["schema_version"] = 0
    out["schema"] = m
    return out


VARIANTS = _variants()


def _compare(gate, manifest, band):
    try:
        return [f.to_dict() for f in
                gate.compare_atlas(manifest, BASELINE, band=band)]
    except gate.IncomparableAtlas as e:
        return ("incomparable", str(e))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_compare_atlas_matches_jax(name):
    """The gate's findings (or its refusal) on each variant, at the
    default band and a tight one."""
    for band in (tgate.CLIFF_BAND, 0.0):
        got = _compare(tgate, VARIANTS[name], band)
        assert got == _compare(jgate, VARIANTS[name], band)
    if name == "same":
        assert _compare(tgate, VARIANTS[name], tgate.CLIFF_BAND) == []


def test_manifest_identity_and_files(tmp_path):
    """A manifest built on the CPU names the JAX CPU platform, so it
    compares with the baseline; save / load round-trip; load refuses
    another kind."""
    assert tsim.device_identity("cpu") == ("cpu", "cpu")
    doc = tmanifest.build_manifest(BASELINE["searches"], device="cpu")
    assert _drop(doc) == _drop(jmanifest.build_manifest(
        BASELINE["searches"]))
    assert tgate.compare_atlas(doc, BASELINE) == []
    path = str(tmp_path / "m.json")
    tmanifest.save_manifest(path, doc)
    assert tmanifest.load_manifest(path) == doc
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    with pytest.raises(ValueError, match="not an atlas manifest"):
        tmanifest.load_manifest(os.path.join(ROOT, "BASELINE.json"))
    with pytest.raises(ValueError, match="unknown atlas search"):
        tmanifest.capture_atlas(("bogus",), device="cpu")
    with pytest.raises(ValueError, match="unknown cliff metric"):
        tsearch.find_cliffs(bt.SimConfig(n_nodes=16, n_faulty=1),
                            "f:1:4", metric="bogus", device="cpu")
