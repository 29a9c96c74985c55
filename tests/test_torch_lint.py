"""benorlint for the port (benor_tpu_torch/analysis/) against the JAX
package's (benor_tpu/analysis/), on the CPU.

  * COMPARISON: the fixture trees of tests/test_lint.py (pragmas, parse
    errors, broad-except, np.random, fold_in products, serve blocking
    calls, layout and pack tables, config parity, manifest kinds) go
    through both linters; the findings are equal in (rule, path, line,
    col), and so are the per-rule counts and the suppressions.  Where a
    table's file moved (ops/pallas_round.py -> ops/packed_round.py) the
    port's tree holds the same file under the port's name.
  * TORCH RULES: each rule the port maps onto torch (host-sync, host-rng,
    traced-branch, dtype-drift, rng-fold, serve-blocking-call,
    perf-unregistered-build, the CUDA constants and SIGNATURES) fires on
    its fixture, a pragma suppresses it, and a mutation of a copy of the
    real port tree is caught — one copy for the module.
  * SHIPPED TREE: the port lints clean with exactly the documented
    suppressions; the report passes the JAX tool's check_lint_report;
    the registry counters tick; ``python -m benor_tpu_torch lint`` exits
    0 with no device; the device-reachable set covers every JAX-traced
    function with a same-file, same-name counterpart, but the reviewed
    host-side ones.

Nothing here compiles, so the JAX side runs in the main process.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import textwrap

import pytest

import test_lint as jl
import torch_no_jax
from benor_tpu.analysis import (rules_config, rules_layout,  # noqa: F401
                                rules_manifest, rules_perf, rules_serve,
                                rules_tracer)  # registers the JAX rules
from benor_tpu.analysis import Project as JProject
from benor_tpu.analysis import RULES as JRULES
from benor_tpu.analysis import run_lint as jrun_lint
from benor_tpu.analysis import run_rules as jrun_rules
from benor_tpu.analysis.core import Source as JSource
from benor_tpu_torch.analysis import Project, RULES, run_lint, run_rules
from benor_tpu_torch.analysis.cli import REPORT_VERSION
from benor_tpu_torch.analysis.core import CudaSource, Source
from benor_tpu_torch.analysis.cli import main as lint_main
from benor_tpu_torch.utils.metrics import REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPKG = os.path.join(ROOT, "benor_tpu")
TPKG = os.path.join(ROOT, "benor_tpu_torch")
check_lint_report = jl.check_metrics_schema.check_lint_report

#: The shipped tree's reviewed exceptions, by rule:
#:  - host-sync: state.witness_node_ids' np.asarray of static config ids,
#:    and 31 int() / float() / bool() conversions of host values (the
#:    config's quorum, F, coin epsilon and flags, the host loop's round
#:    counter, a shard's node count) into the kernels' by-value arguments
#:    and the plain versions' scalars (ops/hist.py, ops/packed_round.py,
#:    ops/rng.py, ops/stream.py, state.py);
#:  - host-rng: sweep.random_inputs (seeded host-side inputs) and
#:    topo/graphs.py's seeded static neighbour table;
#:  - broad-except: the serve plane's two batcher boundaries and its 500
#:    path, and sweep_async's cross-thread relay (re-raises verbatim).
SHIPPED_SUPPRESSED = {"host-sync": 32, "host-rng": 2, "broad-except": 4}

#: JAX-traced functions whose same-file, same-name counterpart in the port
#: runs on the host by design, with the reason; every other counterpart is
#: reachable from sim.DEVICE_ROOTS.
HOST_SIDE = {
    ("sim.py", "run_consensus"): "a jit entry point there; the host "
    "entry point that picks the loop here",
    ("sim.py", "run_consensus_traced"): "the same",
    ("sim.py", "run_consensus_slice"): "the same",
    ("sim.py", "start_state"): "the /start transition, once a run",
    ("sim.py", "delivery_plane"): "a config predicate of the dispatcher",
    ("sim.py", "injection_plane"): "the same",
    ("sim.py", "warn_debug_demotes_pallas"): "a host announcer, once a "
    "process",
    ("sim.py", "warn_faults_demote_pallas"): "the same",
    ("sim.py", "warn_structured_demotes_pallas"): "the same",
    ("ops/tally.py", "pallas_requested"): "a config predicate of the "
    "dispatcher (sim._slice)",
    ("ops/tally.py", "pallas_round_active"): "the same",
    ("state.py", "new_recorder"): "a buffer allocation, once a slice, by "
    "the host loops",
    ("state.py", "new_witness"): "the same",
    ("state.py", "witness_snapshot_row"): "row 0 of new_witness, once a "
    "slice",
    ("state.py", "witness_round_row"): "not on the port's path: the round "
    "functions build the witness row from witness_select (benor_round) "
    "and the kernels' fields (packed_round)",
    ("sweep.py", "summarize_final"): "a point's summary after the loop, "
    "read to the host by design",
    ("sweep.py", "aggregates"): "the same",
    ("sweep.py", "record_trajectory"): "the same",
    ("utils/tracing.py", "emit_round_event"): "the debug event: the host "
    "loops call it after a round under cfg.debug only (the JAX package's "
    "jax.debug.callback)",
}


def _write_pkg(base, files: dict) -> str:
    root = base / "pkg"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def _keys(findings, rename=None):
    rename = rename or {}
    return sorted((f.rule, rename.get(f.path, f.path), f.line, f.col)
                  for f in findings)


def _counts(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def _line_of(src: str, marker: str) -> int:
    for i, line in enumerate(textwrap.dedent(src).splitlines(), start=1):
        if marker in line:
            return i
    raise AssertionError(f"marker {marker!r} not in fixture")


def _edit_text(text, old, new, count=1):
    assert old in text, f"{old!r} not found"
    return text.replace(old, new, count)


def _drop_row(text, table, col):
    """``text`` with the ``col`` row of the literal table ``table`` cut."""
    start = text.index(f"\n{table} = {{")
    end = text.index("\n}\n", start)
    block = text[start:end]
    cut = re.sub(rf'\n    "{col}": \([^\n]*', "", block, count=1)
    assert cut != block, (table, col)
    return text[:start] + cut + text[end:]


# --------------------------------------------------------------------------
# the comparison: the JAX fixture trees through both linters
# --------------------------------------------------------------------------

_KERNEL_RENAME = {"ops/packed_round.py": "ops/pallas_round.py"}

_PRAGMA_SRC = """\
    import numpy as np

    def inputs(n):
        # benorlint: allow-host-rng — seeded host-side input generation
        return np.random.default_rng(0).integers(0, 2, size=n)
"""

_IDENT_SRC = """\
    __all__ = ["save_sweep_manifest", "build_scaling_manifest"]


    def compare(doc):
        return doc.get("kind") == "nonexistent_manifest"
"""

#: name -> (files, rules): small trees written from test_lint's sources.
FIXTURES = {
    "host_rng": ({"gen.py": jl.HOST_RNG_SRC}, None),
    "broad_except": ({"mod.py": jl.BROAD_EXCEPT_SRC}, None),
    "pragma": ({"gen.py": _PRAGMA_SRC}, None),
    "parse_error": ({"broken.py": "def f(:\n"}, None),
    # the fold_in product, outside any trace on both sides
    "fold_in_product": ({"mod.py": jl.RNG_FOLD_SRC.replace(
        "    @jax.jit\n", "")}, None),
    "serve_blocking": ({"srv.py": jl.SERVE_BLOCKING_SRC}, None),
    "serve_pragma": ({"srv.py": jl.SERVE_PRAGMA_SRC}, None),
    "manifest_no_tools": ({"emit.py": jl.MANIFEST_EMIT_SRC}, None),
    "manifest_identifiers": ({"mod.py": _IDENT_SRC}, None),
}


def _compare(jroot, troot, rules=None, rename=None):
    jact, jsup = jrun_rules(JProject(jroot), names=rules)
    tact, tsup = run_rules(Project(troot), names=rules)
    assert _keys(tact, rename) == _keys(jact)
    assert _counts(tact) == _counts(jact)
    assert tsup == jsup
    return jact, jsup


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_findings_equal_jax(tmp_path, name):
    files, rules = FIXTURES[name]
    root = _write_pkg(tmp_path, files)
    jact, jsup = _compare(root, root, rules)
    assert jact or jsup or name == "manifest_identifiers"


def _manifest_tree(tmp_path, drop=None):
    """test_lint's manifest tree: the JAX sweepscope manifest writer and
    the repo's checker registry in the sibling tools/."""
    root = tmp_path / "pkg"
    (root / "sweepscope").mkdir(parents=True)
    shutil.copy(os.path.join(JPKG, "sweepscope", "manifest.py"),
                root / "sweepscope" / "manifest.py")
    (tmp_path / "tools").mkdir()
    text = open(os.path.join(ROOT, "tools", "check_metrics_schema.py")).read()
    if drop:
        text = _edit_text(text, drop[0], drop[1])
    (tmp_path / "tools" / "check_metrics_schema.py").write_text(text)
    return str(root)


@pytest.mark.parametrize("drop", [
    None,
    ('    "sweep_manifest": "check_sweep_manifest",\n', ""),
    ('"check_sweep_manifest"', '"check_sweep_gone"'),
], ids=["clean", "unregistered", "stale_row"])
def test_manifest_tree_findings_equal_jax(tmp_path, drop):
    root = _manifest_tree(tmp_path, drop)
    jact, _ = _compare(root, root, ["manifest-kind-parity"])
    assert bool(jact) == bool(drop)


#: test_lint's table trees: the JAX state.py, config.py and
#: ops/pallas_round.py (layout and pack tables); those with the JAX sim,
#: sweep and mesh regimes (config parity).  The port's tree holds the
#: kernel file under its own name.
_TABLE_TREES = {
    "layout": ("state.py", "config.py", "ops/pallas_round.py"),
    "parity": ("config.py", "sim.py", "sweep.py", "ops/pallas_round.py",
               "parallel/sharded.py", "parallel/multihost.py",
               "parallel/grid.py"),
}


def _port_rel(rel):
    return "ops/packed_round.py" if rel == "ops/pallas_round.py" else rel


@pytest.fixture(scope="module")
def table_bases(tmp_path_factory):
    """tree -> (JAX Project, port Project) of the unedited tree, parsed
    once for the module: a case parses its one edited file again and the
    table rules, which read no index, run on the rest as parsed."""
    out = {}
    for tree, rels in _TABLE_TREES.items():
        roots = []
        for side, name in (("jax", lambda r: r), ("port", _port_rel)):
            root = tmp_path_factory.mktemp(f"{tree}_{side}")
            for rel in rels:
                dst = root / name(rel)
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(os.path.join(JPKG, rel), dst)
            roots.append(str(root))
        out[tree] = (JProject(roots[0]), Project(roots[1]))
    return out


def _compare_edited(bases, tree, edit, rules):
    """_compare's findings on one table tree with ``edit`` ((rel, fn of
    the file's text) or None) applied to both sides."""
    jbase, tbase = bases[tree]
    projects = []
    for base, source, rel in ((jbase, JSource, edit and edit[0]),
                              (tbase, Source, edit and _port_rel(edit[0]))):
        project = copy.copy(base)
        project.sources = dict(base.sources)
        if edit:
            old = base.sources[rel]
            project.sources[rel] = source(old.path, rel, edit[1](old.text))
        projects.append(project)
    jact, jsup = jrun_rules(projects[0], names=rules)
    tact, tsup = run_rules(projects[1], names=rules)
    assert _keys(tact, _KERNEL_RENAME) == _keys(jact)
    assert _counts(tact) == _counts(jact)
    assert tsup == jsup
    return jact


_PACK_EDITS = {
    "clean": None,
    **{f"drop_{f}": (lambda f: lambda t: _drop_row(t, "PACK_LAYOUT", f))(f)
       for f in ("x", "decided", "killed", "coined", "faulty", "down", "k")},
    "overlap": lambda t: _edit_text(t, '    "killed": (3, 1),',
                                    '    "killed": (2, 1),'),
    "too_wide": lambda t: _edit_text(t, '    "k": (7, 25),',
                                     '    "k": (7, 30),'),
    "undeclared_extra": lambda t: _edit_text(
        t, 'PACK_EXTRA_FIELDS = ("faulty", "coined", "down")',
        'PACK_EXTRA_FIELDS = ("faulty", "down")'),
    "deleted": lambda t: _edit_text(t, "PACK_LAYOUT = {",
                                    "PACK_LAYOUT_RENAMED = {"),
}


@pytest.mark.parametrize("case", list(_PACK_EDITS))
def test_pack_tables_findings_equal_jax(table_bases, case):
    """pack-layout and pack-parity read state.py alone, as in the JAX
    package: the JAX state.py and test_lint's mutations of it."""
    edit = _PACK_EDITS[case]
    jact = _compare_edited(table_bases, "layout",
                           edit and ("state.py", edit),
                           ["pack-layout", "pack-parity"])
    assert bool(jact) == (case != "clean")


#: test_lint's layout mutations, the first and last column of each table
#: (the port's own mutation tests below cut every column of the real
#: tables).
_LAYOUT_EDITS = {
    "clean": None,
    "overlap": ("ops/pallas_round.py", lambda t: _edit_text(
        t, '"killed": (6, 1),', '"killed": (5, 1),')),
    **{f"drop_record_{c}": ("ops/pallas_round.py",
                            (lambda c: lambda t: _drop_row(
                                t, "VOTE_RECORD_LAYOUT", c))(c))
       for c in ("decided", "tally_margin")},
    **{f"drop_witness_{f}": ("ops/pallas_round.py",
                             (lambda f: lambda t: _edit_text(
                                 t, f', "{f}"' if f in ("p1", "v1")
                                 else f'"{f}", ', ""))(f))
       for f in ("p0", "p1", "x", "v1")},
    "drop_wit_row": ("state.py", lambda t: _edit_text(
        t, '    "v0": (6, 1),', "")),
    "deleted": ("ops/pallas_round.py", lambda t: _edit_text(
        t, "VOTE_RECORD_LAYOUT = {", "VOTE_RECORD_LAYOUT_RENAMED = {")),
}


@pytest.mark.parametrize("case", list(_LAYOUT_EDITS))
def test_layout_tables_findings_equal_jax(table_bases, case):
    """layout-overlap and layout-parity on test_lint's layout tree and its
    mutations (the port's layout-parity adds the CUDA reads, which a tree
    without csrc/ skips)."""
    jact = _compare_edited(table_bases, "layout", _LAYOUT_EDITS[case],
                           ["layout-overlap", "layout-parity"])
    assert bool(jact) == (case != "clean")


_PARITY_EDITS = {
    "clean": None,
    "sharded_drops_max_rounds": ("parallel/sharded.py", lambda t: t.replace(
        "cfg.max_rounds", "(1 << 20)")),
    "new_field_everywhere": ("sim.py", lambda t: _edit_text(
        t, "if cfg.record or cfg.witness:",
        "if (cfg.record or cfg.witness) and not cfg.poll_rounds:")),
    "sweep_drops_topology": ("sweep.py", lambda t: _edit_text(
        t, "and cfg.topology is None", "")),
}


@pytest.mark.parametrize("case", list(_PARITY_EDITS))
def test_config_parity_findings_equal_jax(table_bases, case):
    jact = _compare_edited(table_bases, "parity", _PARITY_EDITS[case],
                           ["config-parity"])
    assert len(jact) == {"clean": 0, "sharded_drops_max_rounds": 1,
                         "new_field_everywhere": 5,
                         "sweep_drops_topology": 1}[case]


def test_report_documents_match_jax(tmp_path):
    """Both reports of a dirty tree: the same keys, version, findings,
    counts and suppressions, and both pass the JAX tool's checker."""
    root = _write_pkg(tmp_path, {"gen.py": jl.HOST_RNG_SRC,
                                 "mod.py": jl.BROAD_EXCEPT_SRC})
    tdoc, jdoc = run_lint(root).to_dict(), jrun_lint(root).to_dict()
    assert set(tdoc) == set(jdoc) and tdoc["version"] == jdoc["version"]
    assert REPORT_VERSION == 1
    for doc in (tdoc, jdoc):
        assert check_lint_report(doc) == []
    drop = ("message", "hint")
    assert [{k: v for k, v in f.items() if k not in drop}
            for f in tdoc["findings"]] == \
        [{k: v for k, v in f.items() if k not in drop}
         for f in jdoc["findings"]]
    for key in ("ok", "files", "counts", "suppressed", "suppressed_total",
                "root"):
        assert tdoc[key] == jdoc[key], key


def test_rule_roster_against_jax():
    """The JAX rules, but donate-argnums (eager torch donates nothing)
    and perf-unregistered-jit, whose counterpart is
    perf-unregistered-build."""
    want = (set(JRULES) - {"donate-argnums", "perf-unregistered-jit"}) \
        | {"perf-unregistered-build"}
    assert set(RULES) == want
    assert {n: r.family for n, r in RULES.items()} == {
        n: ("perf" if n == "perf-unregistered-build" else
            JRULES[n].family) for n in RULES}


# --------------------------------------------------------------------------
# the torch rules: a fixture that fires, a pragma that suppresses
# --------------------------------------------------------------------------

_ROOTS = 'DEVICE_ROOTS = ("mod.round_fn",)\n'

HOST_SYNC_SRC = """\
    import numpy as np
    import torch


    def round_fn(state, r: int, n, k):
        a = state.sum().item()             # MARK-item
        b = state.tolist()                 # MARK-tolist
        c = state.cpu()                    # MARK-cpu
        d = np.asarray(state)              # MARK-asarray
        e = int(n)                         # MARK-int
        torch.cuda.synchronize()           # MARK-sync
        f = float(r)                       # MARK-annotated
        g = int(k) if isinstance(k, int) else k    # host int: fine
        return a, b, c, d, e, f, g


    def harness(out):
        return out.item(), int(out[0])     # not on the device path
"""

HOST_RNG_TORCH_SRC = """\
    import torch


    def draws(x, g):
        a = torch.rand(3)                  # MARK-rand
        b = torch.randint(0, 2, (3,), generator=g)
        x.uniform_()                       # MARK-uniform
        return a, b, torch.randperm(4)     # MARK-perm
"""

TRACED_BRANCH_SRC = """\
    import torch


    def round_fn(x):
        if x.any():                        # MARK-any
            x = x - 1
        while torch.sum(x) > 0:            # MARK-while
            x = x - 1
        if torch.cuda.is_available():      # a host predicate: fine
            x = x + 0
        if x.shape[0] > 2:                 # static shape: fine
            x = x + 0
        return x
"""

DTYPE_SRC = """\
    import torch


    def round_fn(x):
        a = x.to(torch.float64)            # MARK-f64
        b = x.double()                     # MARK-double
        c = x.to(torch.int64)              # the bit-work width: fine
        return a, b, c
"""

RNG_FOLD_SRC = """\
    from .ops import rng
    from .ops.stream import key_words


    def round_fn(seed, r, t, n, i):
        k = rng.fold_in(rng.round_key(seed, r, 0), t * n + i)  # MARK-flat
        k2 = rng.round_key(seed, r * 2, 0)                     # MARK-rk
        u = rng._uniform(key_words(seed))                      # MARK-raw
        return k, k2, u
"""

SERVE_SRC = """\
    import torch


    async def handler(writer, arr):
        a = arr.cpu()                      # MARK-cpu
        b = arr.tolist()                   # MARK-tolist
        torch.cuda.synchronize()           # MARK-sync
        return a, b


    def worker(arr):
        return arr.cpu()                   # not on the event loop
"""

BUILD_SRC = """\
    import ctypes
    import subprocess

    from torch.utils import cpp_extension


    def build(src):
        subprocess.run(["nvcc", "-c", src])        # MARK-nvcc
        subprocess.run(["ls", src])                 # not a compiler
        lib = ctypes.CDLL("libx.so")                # MARK-cdll
        ext = cpp_extension.load("x", [src])        # MARK-ext
        return lib, ext
"""

#: rule -> (files, {marker...}); a marker names the flagged line.
TORCH_FIXTURES = {
    "host-sync": ({"sim.py": _ROOTS, "mod.py": HOST_SYNC_SRC},
                  ("MARK-item", "MARK-tolist", "MARK-cpu", "MARK-asarray",
                   "MARK-int", "MARK-sync", "MARK-annotated")),
    "host-rng": ({"mod.py": HOST_RNG_TORCH_SRC},
                 ("MARK-rand", "MARK-uniform", "MARK-perm")),
    "traced-branch": ({"sim.py": _ROOTS, "mod.py": TRACED_BRANCH_SRC},
                      ("MARK-any", "MARK-while")),
    "dtype-drift": ({"sim.py": _ROOTS, "mod.py": DTYPE_SRC},
                    ("MARK-f64", "MARK-double")),
    "rng-fold": ({"sim.py": _ROOTS, "mod.py": RNG_FOLD_SRC},
                 ("MARK-flat", "MARK-rk", "MARK-raw")),
    "serve-blocking-call": ({"mod.py": SERVE_SRC},
                            ("MARK-cpu", "MARK-tolist", "MARK-sync")),
    "perf-unregistered-build": ({"mod.py": BUILD_SRC},
                                ("MARK-nvcc", "MARK-cdll", "MARK-ext")),
}


@pytest.mark.parametrize("rule_name", list(TORCH_FIXTURES))
def test_torch_rule_fires_on_fixture(tmp_path, rule_name):
    files, marks = TORCH_FIXTURES[rule_name]
    src = files["mod.py"]
    active, _ = run_rules(Project(_write_pkg(tmp_path, files)),
                          names=[rule_name])
    assert [(f.path, f.line) for f in active] == \
        sorted(("mod.py", _line_of(src, m)) for m in marks)
    assert {f.rule for f in active} == {rule_name}


@pytest.mark.parametrize("rule_name", list(TORCH_FIXTURES))
def test_torch_rule_pragma_suppresses(tmp_path, rule_name):
    files, marks = TORCH_FIXTURES[rule_name]
    src = textwrap.dedent(files["mod.py"])
    lines = src.splitlines()
    for m in marks:
        i = _line_of(src, m) - 1
        lines[i] = f"{lines[i]}  # benorlint: allow-{rule_name} — fixture"
    files = dict(files, **{"mod.py": "\n".join(lines) + "\n"})
    active, suppressed = run_rules(Project(_write_pkg(tmp_path, files)),
                                   names=[rule_name])
    assert active == []
    assert suppressed == {rule_name: len(marks)}


def test_device_roots_stale_or_missing_is_a_finding(tmp_path):
    """An entry that resolves to nothing, or a roster that is gone, is a
    host-sync finding at sim.py — the rules never go blind silently."""
    stale = _write_pkg(tmp_path / "a", {
        "sim.py": 'DEVICE_ROOTS = ("mod.round_fn", "mod.gone")\n',
        "mod.py": "def round_fn(x):\n    return x\n"})
    active, _ = run_rules(Project(stale), names=["host-sync"])
    assert [(f.path, "'mod.gone'" in f.message) for f in active] == \
        [("sim.py", True)]
    gone = _write_pkg(tmp_path / "b", {"sim.py": "ROOTS = ()\n"})
    active, _ = run_rules(Project(gone), names=["host-sync"])
    assert len(active) == 1 and "missing" in active[0].message


# --------------------------------------------------------------------------
# mutations of one copy of the real port tree
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """(root, base Project): one copy of benor_tpu_torch/ for the module;
    each case edits a file, lints the copy with that one file parsed
    again (the others' parses are the base's), and puts the file
    back."""
    root = tmp_path_factory.mktemp("copy") / "benor_tpu_torch"
    shutil.copytree(TPKG, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(root), Project(str(root))


def _mutant(port_tree, rel, edit, rules):
    root, base = port_tree
    path = os.path.join(root, rel)
    with open(path) as fh:
        text = fh.read()
    try:
        with open(path, "w") as fh:
            fh.write(edit(text))
        project = copy.copy(base)
        project.__dict__.pop("index", None)      # rebuilt on first use
        project.sources, project.cuda = dict(base.sources), dict(base.cuda)
        if rel in base.cuda:
            project.cuda[rel] = CudaSource(path, rel, edit(text))
        else:
            project.sources[rel] = Source(path, rel, edit(text))
        return run_rules(project, names=rules)[0]
    finally:
        with open(path, "w") as fh:
            fh.write(text)


_ALL_LAYOUT = ["layout-overlap", "layout-parity", "pack-layout",
               "pack-parity", "telem-layout", "layout-outspec"]

#: name -> (file, edit, rules, the rule that must fire).
MUTATIONS = {
    "item_in_packed_round": (
        "ops/packed_round.py", lambda t: _edit_text(
            t, "    row = wrow = None\n",
            "    row = wrow = None\n    _ = pack.sum().item()\n"),
        ["host-sync"], "host-sync"),
    "global_rand_in_round": (
        "models/benor.py", lambda t: _edit_text(
            t, "    if recorder is None and witness is None:\n",
            "    _ = torch.rand(3)\n"
            "    if recorder is None and witness is None:\n"),
        ["host-rng"], "host-rng"),
    "branch_on_any_in_round": (
        "models/benor.py", lambda t: _edit_text(
            t, "    if recorder is None and witness is None:\n",
            "    if new_decided.any():\n        pass\n"
            "    if recorder is None and witness is None:\n"),
        ["traced-branch"], "traced-branch"),
    "float64_in_round": (
        "ops/packed_round.py", lambda t: _edit_text(
            t, "    row = wrow = None\n",
            "    row = wrow = None\n    _ = pack.to(torch.float64)\n"),
        ["dtype-drift"], "dtype-drift"),
    "cdll_outside_build": (
        "ops/hist.py", lambda t: _edit_text(
            t, "from __future__ import annotations\n",
            "from __future__ import annotations\n\nimport ctypes\n\n"
            "_LIB = ctypes.CDLL('libbenor_kernels.so')\n"),
        ["perf-unregistered-build"], "perf-unregistered-build"),
    "sync_in_async_server": (
        "serve/server.py", lambda t: _edit_text(_edit_text(
            t, "await writer.drain()", "torch.cuda.synchronize()"),
            "import asyncio\n", "import asyncio\nimport torch\n"),
        ["serve-blocking-call"], "serve-blocking-call"),
    "cuda_constant_changed": (
        "csrc/round_body.cuh", lambda t: _edit_text(
            t, "constexpr int kVoteObsCols = 12;",
            "constexpr int kVoteObsCols = 13;"),
        _ALL_LAYOUT, "layout-parity"),
    "cuda_constant_expression": (
        "csrc/round_body.cuh", lambda t: _edit_text(
            t, "constexpr int kTileWords = 16;",
            "constexpr int kTileWords = 512 / 32;"),
        _ALL_LAYOUT, "telem-layout"),
    "signature_one_argtype_fewer": (
        "ops/_build.py", lambda t: _edit_text(
            t, '"benor_hist_wave": [_I, _P],', '"benor_hist_wave": [_I],'),
        _ALL_LAYOUT, "layout-outspec"),
    "signature_kind_swapped": (
        "ops/_build.py", lambda t: _edit_text(
            t, '"benor_hist_wave": [_I, _P],', '"benor_hist_wave": [_P, _I],'),
        _ALL_LAYOUT, "layout-outspec"),
    "signature_unknown_ctype": (
        "ops/_build.py", lambda t: _edit_text(
            t, '"benor_hist_wave": [_I, _P],',
            '"benor_hist_wave": [ctypes.c_int64, _P],'),
        _ALL_LAYOUT, "layout-outspec"),
    "c_parameter_unknown_type": (
        "csrc/hist_kernels.cu", lambda t: _edit_text(
            t, 'extern "C" int benor_hist_wave(int kernel, int* wave)',
            'extern "C" int benor_hist_wave(int64_t kernel, int* wave)'),
        _ALL_LAYOUT, "layout-outspec"),
    "stale_device_root": (
        "sim.py", lambda t: _edit_text(
            t, '"models.benor.all_settled",', '"models.benor.all_gone",'),
        ["host-sync"], "host-sync"),
    "stale_library_row": (
        "ops/_build.py", lambda t: _edit_text(
            t, '"ops.sass._compile",', '"ops.sass._gone",'),
        ["perf-unregistered-build"], "perf-unregistered-build"),
    **{f"drop_rec_{c}": ("state.py", (lambda c: lambda t: _drop_row(
        t, "REC_LAYOUT", c))(c), _ALL_LAYOUT, None)
       for c in ("decided", "killed", "undecided_0", "undecided_1",
                 "undecided_q", "coin_flips", "tally_margin")},
    **{f"drop_telem_{c}": ("ops/packed_round.py", (lambda c: lambda t:
                           _drop_row(t, "TELEM_COLS", c))(c),
                           _ALL_LAYOUT, "telem-layout")
       for c in ("active_lanes", "pad_lanes", "sampler_draws",
                 "hist_visits", "quorum_passes", "coin_draws",
                 "plane_hops")},
    **{f"drop_pack_{c}": ("state.py", (lambda c: lambda t: _drop_row(
        t, "PACK_LAYOUT", c))(c), _ALL_LAYOUT, None)
       for c in ("x", "decided", "killed", "coined", "faulty", "down",
                 "k")},
}


def test_copied_tree_is_clean(port_tree):
    """The copy lints clean on the rules the mutations use (the manifest
    rule needs the repo's tools/ beside the tree, so it is left out)."""
    active, suppressed = run_rules(
        port_tree[1], names=[r for r in RULES
                             if r != "manifest-kind-parity"])
    assert active == [] and suppressed == SHIPPED_SUPPRESSED


@pytest.mark.parametrize("case", list(MUTATIONS))
def test_mutation_of_real_tree_is_caught(port_tree, case):
    rel, edit, rules, must = MUTATIONS[case]
    active = _mutant(port_tree, rel, edit, rules)
    assert active, f"{case} went unnoticed"
    if must is not None:
        assert must in {f.rule for f in active}, [f.rule for f in active]


def test_missing_cuda_sources_are_findings(port_tree):
    """A tree that builds a kernel library (ops/_build.py) but holds no
    csrc/ source: the CUDA constants and the SIGNATURES rows cannot be
    read, and each rule that reads them says so."""
    project = copy.copy(port_tree[1])
    project.__dict__.pop("index", None)
    project.cuda = {}
    active, _ = run_rules(project, names=_ALL_LAYOUT)
    assert sorted((f.rule, f.path) for f in active) == [
        ("layout-outspec", "ops/_build.py"),
        ("layout-parity", "ops/_build.py"),
        ("telem-layout", "ops/_build.py")]
    assert all("no csrc/" in f.message for f in active)


# --------------------------------------------------------------------------
# the shipped tree, the report, the registry and the CLI
# --------------------------------------------------------------------------


torch_no_jax.script("lint", """
    import runpy, sys
    sys.argv = ["benor_tpu_torch", "lint", "--format", "json"]
    try:
        runpy.run_module("benor_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        print("EXIT", e.code)
""")


@pytest.fixture(scope="module")
def shipped():
    """The shipped tree's report, from ``python -m benor_tpu_torch lint
    --format json`` run by ``runpy`` in the shared child process of
    tests/torch_no_jax.py (no CUDA device visible, JAX unimportable):
    (report document, exit status line)."""
    out, error = torch_no_jax.result("lint")
    assert error == "", error
    report, _, status = out.strip().rpartition("\n")
    return json.loads(report), status


def test_shipped_tree_lints_clean(shipped):
    doc = shipped[0]
    assert doc["findings"] == [], doc["findings"]
    assert doc["suppressed"] == SHIPPED_SUPPRESSED
    assert doc["files"] >= 80 and doc["root"] == TPKG


def test_shipped_report_passes_jax_schema(shipped):
    doc = shipped[0]
    assert check_lint_report(doc) == []
    assert doc["ok"] is True and doc["suppressed_total"] == 38
    assert doc["rules_run"] == sorted(RULES)


def test_lint_feeds_metrics_registry(tmp_path):
    """run_lint ticks analysis.runs / .files / .findings / .suppressed and
    the analysis.lint timer (a tree with one finding and one pragma)."""
    root = _write_pkg(tmp_path, {"gen.py": _PRAGMA_SRC,
                                 "mod.py": jl.BROAD_EXCEPT_SRC})
    before = {n: REGISTRY.counter(f"analysis.{n}").value
              for n in ("runs", "files", "findings", "suppressed")}
    timed = REGISTRY.timer("analysis.lint").count
    rep = run_lint(root)
    after = {n: REGISTRY.counter(f"analysis.{n}").value for n in before}
    assert REGISTRY.timer("analysis.lint").count == timed + 1
    assert after["runs"] == before["runs"] + 1
    assert after["files"] == before["files"] + rep.files == \
        before["files"] + 2
    assert after["findings"] == before["findings"] + 1
    assert after["suppressed"] == before["suppressed"] + 1


def test_cli_main_exit_codes_and_metrics_out(tmp_path):
    """The subcommand body: 0 and the report file on a clean tree, 2 on a
    dirty one, and --metrics-out writes the registry (the shipped tree's
    exit 0 in the process is tests/test_torch_cli.py's)."""
    class Args:
        root = _write_pkg(tmp_path / "clean", {"mod.py": "X = 1\n"})
        format = "json"
        out = str(tmp_path / "report.json")
        metrics_out = str(tmp_path / "m.jsonl")

    assert lint_main(Args()) == 0
    doc = json.loads((tmp_path / "report.json").read_text())
    assert check_lint_report(doc) == [] and doc["ok"] is True
    names = {json.loads(line)["name"]
             for line in (tmp_path / "m.jsonl").read_text().splitlines()}
    assert {"analysis.runs", "analysis.lint"} <= names

    class Dirty(Args):
        root = _write_pkg(tmp_path, {"gen.py": jl.HOST_RNG_SRC})
        out = str(tmp_path / "dirty.json")
        metrics_out = None

    assert lint_main(Dirty()) == 2
    doc = json.loads((tmp_path / "dirty.json").read_text())
    assert doc["ok"] is False and doc["counts"] == {"host-rng": 1}


def test_cli_subprocess_exit_0_without_device(shipped):
    """`python -m benor_tpu_torch lint --format json`, as a user runs it
    (``runpy`` in the shared child process of tests/torch_no_jax.py, where
    no CUDA device is visible and JAX cannot be imported): exit 0 with no
    --device."""
    doc, status = shipped
    assert status == "EXIT 0"
    assert check_lint_report(doc) == []
    assert doc["suppressed"] == SHIPPED_SUPPRESSED


def test_reachable_set_covers_jax_traced_set(port_tree):
    """Every JAX-traced function with a same-file, same-name counterpart in
    the port is reachable from sim.DEVICE_ROOTS, but the reviewed
    host-side ones; and every reviewed entry is such a counterpart and is
    indeed not reachable (the list cannot go stale).  The port's index is
    the unchanged copy's."""
    jtraced = {(f.rel, f.name) for f in JProject(JPKG).index.traced}
    tindex = port_tree[1].index
    tfuncs = {(f.rel, f.name) for f in tindex.funcs.values()}
    reach = {(f.rel, f.name) for f in tindex.traced}
    counterparts = jtraced & tfuncs
    assert len(counterparts) >= 80
    assert sorted(counterparts - reach - set(HOST_SIDE)) == []
    assert set(HOST_SIDE) <= counterparts - reach
    assert tindex.root_errors == []
