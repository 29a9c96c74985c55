"""Kernel column-layout rules: prove the declarative layout tables are
internally disjoint, agree across files, and agree with the CUDA kernels
(port of benor_tpu/analysis/rules_layout.py).

The bug surface is the one the JAX package's flight recorder and witness
traces managed by hand: the round kernels emit telemetry and witness data
as EXTRA COLUMNS of their per-block partials, and nothing at run time
notices two features landing on the same column — the numbers are merely
silently wrong in one regime.  The tables these rules parse
(state.REC_LAYOUT / WIT_LAYOUT / PACK_LAYOUT,
ops/packed_round.PROP_PARTIAL_LAYOUT / VOTE_PARTIAL_LAYOUT /
VOTE_RECORD_LAYOUT / WITNESS_*_FIELDS / TELEM_COLS) are the literals the
plain versions derive their indices from.

The port's kernels are CUDA C++, and their side of every table is a bare
int that only a comment ties to the table (csrc/round_body.cuh:
``kPlaneX`` … ``kPlaneK``, ``kPropCols``, ``kVoteCols``,
``kVoteObsCols``, ``kMarginCol``, ``kWitPropFields``,
``kWitVoteFields``, ``kTelemWidth``, ``kTelemHist`` / ``kTelemQuorum`` /
``kTelemCoin``, ``kTileWords``).  The JAX package pins its budgets to
``PARTIAL_COLS`` and its ``out_spec`` shapes; the port has neither, so
``layout-parity`` and ``telem-layout`` hold those constants to the
extents derived from the tables, and ``layout-outspec`` holds the
kernels' C interface — the port's out_spec — to ops/_build.SIGNATURES:
every row names an ``extern "C"`` entry point of csrc/*.cu with that
many parameters of those kinds (a ctypes arity mismatch corrupts
silently), and every entry point has a row.

Tables are read by PARSING the source (core.literal_assign) and the CUDA
sources are read as text with a small regex over their comment-stripped
code — never by importing or compiling — so the rules also run over
fixture trees in tests.  A table, a constant or an entry point that the
reader cannot find or evaluate is a finding that says so, never a guess;
a tree with no CUDA sources at all (a fixture) skips the CUDA reads.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from .core import (Finding, Project, assign_line, assign_node,
                   literal_assign, rule)

#: Where each table lives, package-root-relative.
STATE_FILE = "state.py"
KERNEL_FILE = "ops/packed_round.py"
STREAM_FILE = "ops/stream.py"
BUILD_FILE = "ops/_build.py"

_STATE_TABLES = ("REC_LAYOUT", "WIT_LAYOUT")
_KERNEL_TABLES = ("PROP_PARTIAL_LAYOUT", "VOTE_PARTIAL_LAYOUT",
                  "VOTE_RECORD_LAYOUT")

#: The one telemetry emission site of the plain versions.
_TELEM_EMITTER = "_telem_block"

#: ``constexpr int kA = 1, kB = 2;`` (array and template constants are
#: not matched: their declarator carries ``[`` or ``<``).
_CONSTEXPR_RE = re.compile(r"\bconstexpr\s+int\s+([^;\[<]+);")
_INT_RE = re.compile(r"\A-?\d+\Z")

#: ``extern "C" <type> name(<params>)``
_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)', re.S)

#: ctypes spellings -> the parameter kind a SIGNATURES row declares.
_CTYPES_KIND = {"c_void_p": "pointer", "c_int": "int", "c_int32": "int",
                "c_uint32": "uint32", "c_uint": "uint32",
                "c_float": "float"}
#: C parameter types -> kind (a ``*`` or a stream handle is a pointer).
_C_KIND = {"int": "int", "int32_t": "int", "uint32_t": "uint32",
           "unsigned": "uint32", "float": "float",
           "cudaStream_t": "pointer"}


def _table(project: Project, rel: str, name: str,
           rule_name: str = "layout-overlap"
           ) -> Tuple[Optional[dict], int, List[Finding]]:
    """(table, line, findings): parse one layout table; a missing or
    non-literal table is itself a finding (deleting the table must not
    silently disable the checker)."""
    src = project.source(rel)
    if src is None:
        return None, 1, []          # file outside this lint root
    table = literal_assign(src, name)
    line = assign_line(src, name)
    if table is None:
        return None, line, [Finding(
            rule_name, rel, line, 0,
            f"machine-readable layout table {name} is missing (or no "
            f"longer a pure literal) — the kernels and the layout "
            f"checker both consume it",
            hint=f"declare {name} as a literal name -> (base, width) "
                 f"dict at module level")]
    if not isinstance(table, dict) or not all(
            isinstance(v, tuple) and len(v) == 2 and
            all(isinstance(x, int) for x in v) for v in table.values()):
        return None, line, [Finding(
            rule_name, rel, line, 0,
            f"layout table {name} must map name -> (base, width) int "
            f"pairs",
            hint="see state.REC_LAYOUT for the shape")]
    return table, line, []


def _by_base(table: dict) -> List[Tuple[str, int, int]]:
    return sorted(((n, b, w) for n, (b, w) in table.items()),
                  key=lambda t: t[1])


def _extent(*tabs) -> int:
    return max(b + w for t in tabs for b, w in t.values())


def _check_ranges(rel: str, line: int, label: str, entries,
                  start: int,
                  rule_name: str = "layout-overlap") -> List[Finding]:
    """Disjoint + contiguous from ``start`` (positional renderers and
    the kernels' emission order both index columns densely)."""
    findings = []
    expect = start
    for name, base, width in entries:
        if width < 1:
            findings.append(Finding(
                rule_name, rel, line, 0,
                f"{label}[{name!r}] has width {width} < 1"))
            continue
        if base < expect:
            findings.append(Finding(
                rule_name, rel, line, 0,
                f"{label}[{name!r}] at columns [{base}, {base + width}) "
                f"overlaps the previous entry (next free column is "
                f"{expect})",
                hint="re-base the column block; the derived indices "
                     "follow the table automatically"))
        elif base > expect:
            findings.append(Finding(
                rule_name, rel, line, 0,
                f"{label} has a gap before {name!r}: columns "
                f"[{expect}, {base}) are unassigned — positional "
                f"consumers (REC_COLUMNS zips, kernel emission order) "
                f"would mis-align",
                hint="keep the table dense from its start column"))
        expect = max(expect, base + width)
    return findings


# --------------------------------------------------------------------------
# The CUDA side: constants and entry points, read as text
# --------------------------------------------------------------------------


def cuda_constants(project: Project) -> Dict[str, List[tuple]]:
    """name -> [(rel, line, value)] of every ``constexpr int`` of the CUDA
    sources; ``value`` is an int, or the declarator's text where it is
    an expression the reader does not evaluate."""
    out: Dict[str, List[tuple]] = {}
    for rel in sorted(project.cuda):
        src = project.cuda[rel]
        for m in _CONSTEXPR_RE.finditer(src.code):
            line = src.line_of(m.start())
            for decl in m.group(1).split(","):
                name, eq, value = decl.partition("=")
                name, value = name.strip(), value.strip()
                if not eq or not name.isidentifier():
                    continue
                out.setdefault(name, []).append(
                    (rel, line, int(value) if _INT_RE.match(value)
                     else value))
    return out


def _check_constants(project: Project, rule_name: str,
                     want: List[Tuple[str, int, str]]) -> List[Finding]:
    """Hold each CUDA constant of ``want`` ((name, expected value, what
    the value is derived from)) to its derived value.  A missing constant,
    or one whose value is not an int literal, is a finding; so is a tree
    that builds a kernel library (ops/_build.py) but holds no CUDA
    source.  A tree with neither (a fixture tree) skips."""
    if not project.cuda:
        return _no_sources(project, rule_name, "its CUDA constants")
    consts = cuda_constants(project)
    anchor = sorted(project.cuda)[0]
    findings: List[Finding] = []
    for name, expect, origin in want:
        defs = consts.get(name)
        if not defs:
            findings.append(Finding(
                rule_name, anchor, 1, 0,
                f"CUDA constant {name} (the kernels' side of {origin}) "
                f"is defined in no csrc/ source — the table-to-kernel "
                f"check has nothing to compare",
                hint=f"declare `constexpr int {name} = {expect};` next to "
                     f"the kernels that use it"))
            continue
        for rel, line, value in defs:
            if not isinstance(value, int):
                findings.append(Finding(
                    rule_name, rel, line, 0,
                    f"CUDA constant {name} = {value!r} is not an int "
                    f"literal: the layout reader does not evaluate "
                    f"expressions or macros, so it cannot hold it to "
                    f"{origin} ({expect})",
                    hint=f"spell it `constexpr int {name} = {expect};`"))
            elif value != expect:
                findings.append(Finding(
                    rule_name, rel, line, 0,
                    f"CUDA constant {name} = {value} but {origin} gives "
                    f"{expect}: the kernels would read or write other "
                    f"columns than the plain versions and the host "
                    f"assembly",
                    hint=f"set {name} to {expect}, or change the table "
                         f"and the constant together"))
    return findings


def _no_sources(project: Project, rule_name: str,
                what: str) -> List[Finding]:
    """[one finding] when the tree builds a kernel library (has
    ops/_build.py) but no CUDA source under csrc/, else []."""
    if project.source(BUILD_FILE) is None:
        return []
    return [Finding(
        rule_name, BUILD_FILE, 1, 0,
        f"{BUILD_FILE} builds a kernel library but the tree holds no "
        f"csrc/*.cu or *.cuh source: {what} cannot be read",
        hint="keep the CUDA sources under csrc/ beside the package")]


def extern_entries(project: Project) -> Dict[str, Tuple[str, int, list]]:
    """name -> (rel, line, [(parameter kind or None, its C type)]) of
    every ``extern "C"`` function of the ``.cu`` sources."""
    out: Dict[str, Tuple[str, int, list]] = {}
    for rel in sorted(project.cuda):
        if not rel.endswith(".cu"):
            continue
        src = project.cuda[rel]
        for m in _EXTERN_RE.finditer(src.code):
            params = [p.strip() for p in m.group(2).split(",")]
            if params in ([""], ["void"]):
                params = []
            kinds = []
            for p in params:
                if "*" in p:
                    kinds.append(("pointer", p))
                    continue
                words = [w for w in p.split() if w != "const"]
                kinds.append((_C_KIND.get(words[0]) if len(words) >= 2
                              else None, " ".join(words[:-1]) or p))
            out.setdefault(m.group(1),
                           (rel, src.line_of(m.start()), kinds))
    return out


def _signature_rows(project: Project):
    """(rows, line, findings): ops/_build.SIGNATURES parsed as a dict of
    entry-point name -> [(argtype kind or None, its spelling)]; the kinds
    resolve through the module's ``_X = ctypes.c_...`` aliases."""
    src = project.source(BUILD_FILE)
    if src is None:
        return None, 1, []
    aliases = {}
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Attribute):
            aliases[node.targets[0].id] = node.value.attr
    node = assign_node(src, "SIGNATURES")
    line = assign_line(src, "SIGNATURES")
    if node is None or not isinstance(node.value, ast.Dict) or not all(
            isinstance(k, ast.Constant) and isinstance(k.value, str)
            and isinstance(v, (ast.List, ast.Tuple))
            for k, v in zip(node.value.keys, node.value.values)):
        return None, line, [Finding(
            "layout-outspec", BUILD_FILE, line, 0,
            "SIGNATURES is missing (or no longer a dict literal of entry "
            "point -> argtype list) — the kernels' C interface cannot be "
            "held to the csrc/ entry points",
            hint="declare SIGNATURES as {name: [argtypes...]} at module "
                 "level")]
    rows = {}
    for k, v in zip(node.value.keys, node.value.values):
        kinds = []
        for e in v.elts:
            name = e.id if isinstance(e, ast.Name) else (
                e.attr if isinstance(e, ast.Attribute) else None)
            ctype = aliases.get(name, name)
            kinds.append((_CTYPES_KIND.get(ctype),
                          ctype or ast.get_source_segment(src.text, e)))
        rows[k.value] = (k.lineno, kinds)
    return rows, line, []


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------


@rule("layout-overlap", "layout",
      "layout-table column ranges must be disjoint and dense")
def check_layout_overlap(project: Project) -> List[Finding]:
    findings = []
    for rel, names in ((STATE_FILE, _STATE_TABLES),
                       (KERNEL_FILE, _KERNEL_TABLES)):
        if project.source(rel) is None:
            continue
        tables = {}
        for name in names:
            table, line, errs = _table(project, rel, name)
            findings += errs
            if table is not None:
                tables[name] = (table, line)
        for name, (table, line) in tables.items():
            start = 0
            if name == "VOTE_RECORD_LAYOUT" and \
                    "VOTE_PARTIAL_LAYOUT" in tables:
                # the recorder block bases directly after the vote
                # kernel's base partials — a gap or overlap between the
                # two is the hand-assignment bug
                base_tab = tables["VOTE_PARTIAL_LAYOUT"][0]
                start = max(b + w for b, w in base_tab.values())
            findings += _check_ranges(rel, line, name, _by_base(table),
                                      start)
    return findings


@rule("layout-parity", "layout",
      "recorder/witness/pack layouts must agree across state.py, the "
      "plain kernels and the CUDA constants")
def check_layout_parity(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    if project.source(STATE_FILE) is None or \
            project.source(KERNEL_FILE) is None:
        return findings
    rec, rec_line, e1 = _table(project, STATE_FILE, "REC_LAYOUT")
    wit, wit_line, e2 = _table(project, STATE_FILE, "WIT_LAYOUT")
    vote, _, e3 = _table(project, KERNEL_FILE, "VOTE_PARTIAL_LAYOUT")
    vrec, vrec_line, e4 = _table(project, KERNEL_FILE,
                                 "VOTE_RECORD_LAYOUT")
    prop, _, e5 = _table(project, KERNEL_FILE, "PROP_PARTIAL_LAYOUT")
    # missing tables are reported by layout-overlap; don't double up
    if any((rec is None, wit is None, vote is None, vrec is None,
            prop is None)):
        return findings

    ksrc = project.source(KERNEL_FILE)
    pf = literal_assign(ksrc, "WITNESS_PROP_FIELDS")
    vf = literal_assign(ksrc, "WITNESS_VOTE_FIELDS")
    for name, val in (("WITNESS_PROP_FIELDS", pf),
                      ("WITNESS_VOTE_FIELDS", vf)):
        if val is None:
            findings.append(Finding(
                "layout-parity", KERNEL_FILE,
                assign_line(ksrc, name), 0,
                f"{name} is missing (or not a pure literal)",
                hint="the witness field tuples must be machine-readable"))
    if pf is None or vf is None:
        return findings

    # 1. the vote kernel's recorder block is state.REC_LAYOUT, column
    #    for column, in the same order
    rec_cols = [n for n, _, _ in _by_base(rec)]
    vrec_cols = [n for n, _, _ in _by_base(vrec)]
    if rec_cols != vrec_cols:
        findings.append(Finding(
            "layout-parity", KERNEL_FILE, vrec_line, 0,
            f"VOTE_RECORD_LAYOUT columns {vrec_cols} != state.REC_LAYOUT "
            f"columns {rec_cols}: the kernel would emit telemetry rows "
            f"the host renderers mis-label",
            hint="keep both tables name-identical and base-ordered"))
    rec_width = _extent(rec)
    vrec_width = _extent(vrec, vote) - _extent(vote)
    if rec_width != vrec_width:
        findings.append(Finding(
            "layout-parity", STATE_FILE, rec_line, 0,
            f"state.REC_WIDTH ({rec_width}) != the vote kernel's "
            f"recorder block width ({vrec_width}): packed_round would "
            f"assemble rows of the wrong shape",
            hint="add/remove the column in BOTH layout tables"))

    # 2. the witness field tuples cover state.WIT_LAYOUT exactly, minus
    #    the host-set "written" sentinel
    wit_names = set(wit)
    kernel_names = set(pf) | set(vf) | {"written"}
    if len(pf) + len(vf) + 1 != len(set(pf) | set(vf)) + 1 or \
            wit_names != kernel_names:
        missing = sorted(wit_names - kernel_names)
        extra = sorted(kernel_names - wit_names)
        findings.append(Finding(
            "layout-parity", STATE_FILE, wit_line, 0,
            f"WIT_LAYOUT columns and the kernels' witness fields "
            f"disagree (not emitted by any kernel: {missing}; emitted "
            f"but undeclared: {extra})",
            hint="WITNESS_PROP_FIELDS + WITNESS_VOTE_FIELDS + "
                 "{'written'} must equal state.WIT_LAYOUT's names"))
    wit_width = _extent(wit)
    if wit_width != len(pf) + len(vf) + 1:
        findings.append(Finding(
            "layout-parity", STATE_FILE, wit_line, 0,
            f"state.WIT_WIDTH ({wit_width}) != kernel witness fields + "
            f"sentinel ({len(pf) + len(vf) + 1})",
            hint="the witness row assembly indexes by WIT_LAYOUT; the "
                 "kernels emit per-field columns — widths must match"))

    # 3. the CUDA kernels' bare ints equal the tables' extents
    want = [
        ("kPropCols", _extent(prop), "PROP_PARTIAL_LAYOUT's extent"),
        ("kVoteCols", _extent(vote), "VOTE_PARTIAL_LAYOUT's extent"),
        ("kVoteObsCols", _extent(vote, vrec),
         "VOTE_PARTIAL_LAYOUT + VOTE_RECORD_LAYOUT's extent"),
        ("kWitPropFields", len(pf), "len(WITNESS_PROP_FIELDS)"),
        ("kWitVoteFields", len(vf), "len(WITNESS_VOTE_FIELDS)"),
    ]
    if "tally_margin" in vrec:
        want.append(("kMarginCol", vrec["tally_margin"][0],
                     "VOTE_RECORD_LAYOUT['tally_margin']"))
    pack = literal_assign(project.source(STATE_FILE), "PACK_LAYOUT")
    if isinstance(pack, dict):
        for field, const in (("x", "kPlaneX"), ("decided", "kPlaneDecided"),
                             ("killed", "kPlaneKilled"),
                             ("coined", "kPlaneCoined"),
                             ("faulty", "kPlaneFaulty"),
                             ("down", "kPlaneDown"), ("k", "kPlaneK")):
            if isinstance(pack.get(field), tuple):
                want.append((const, pack[field][0],
                             f"PACK_LAYOUT[{field!r}]'s base plane"))
    findings += _check_constants(project, "layout-parity", want)
    return findings


@rule("pack-layout", "layout",
      "the packed-state bit-field table must be overlap-free, dense and "
      "fit one uint32 word")
def check_pack_layout(project: Project) -> List[Finding]:
    """state.PACK_LAYOUT is the declarative bit-field layout of the round
    kernels' plane-packed node state — the same silent-corruption surface
    as the partial-column tables: two fields on the same plane, a gap the
    loads mis-index across, or a field running off the 32-bit word all
    keep compiling and merely corrupt one regime's numbers.  Prove:
    (base, width) ranges disjoint + dense from bit 0, every width >= 1,
    and total extent <= the word width (state.PACK_NODES_PER_WORD — one
    bit per node per plane word, so the whole layout must fit a 32-plane
    stack)."""
    findings: List[Finding] = []
    if project.source(STATE_FILE) is None:
        return findings
    table, line, errs = _table(project, STATE_FILE, "PACK_LAYOUT",
                               rule_name="pack-layout")
    findings += errs
    if table is None:
        return findings
    findings += _check_ranges(STATE_FILE, line, "PACK_LAYOUT",
                              _by_base(table), 0,
                              rule_name="pack-layout")
    src = project.source(STATE_FILE)
    word = literal_assign(src, "PACK_NODES_PER_WORD")
    if word is None:
        findings.append(Finding(
            "pack-layout", STATE_FILE,
            assign_line(src, "PACK_NODES_PER_WORD"), 0,
            "PACK_NODES_PER_WORD is missing (or not a pure literal) — "
            "the pack word width must be machine-readable",
            hint="declare it as a literal int next to PACK_LAYOUT"))
        return findings
    extent = max(b + w for b, w in table.values())
    if extent > word:
        findings.append(Finding(
            "pack-layout", STATE_FILE, line, 0,
            f"PACK_LAYOUT spans {extent} bits but the pack word is "
            f"{word} bits wide: the plane stack could not be transposed "
            f"into one word per node and the declared widths lie",
            hint="shrink a field width (the k cap is the usual culprit) "
                 "or re-base the table"))
    return findings


def _netstate_fields(src) -> Optional[List[str]]:
    """NetState's annotated field names, by PARSING state.py (never by
    import — the core.py contract)."""
    for node in src.nodes:
        if isinstance(node, ast.ClassDef) and node.name == "NetState":
            return [s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
    return None


@rule("pack-parity", "layout",
      "PACK_LAYOUT field names must cover NetState's fields plus "
      "PACK_EXTRA_FIELDS exactly")
def check_pack_parity(project: Project) -> List[Finding]:
    """The packed/unpacked parity contract: every NetState leaf must
    have a bit-field in PACK_LAYOUT (or pack/unpack silently drops
    state), and every non-NetState field the kernels pack must be
    declared in PACK_EXTRA_FIELDS (or it rides the stack undocumented).
    Removing any single field from the table breaks the set equality —
    the mutation tests in tests/test_torch_lint.py pin that."""
    findings: List[Finding] = []
    src = project.source(STATE_FILE)
    if src is None:
        return findings
    table, line, errs = _table(project, STATE_FILE, "PACK_LAYOUT")
    if table is None:
        return findings          # pack-layout already reports this
    extra = literal_assign(src, "PACK_EXTRA_FIELDS")
    if extra is None or not isinstance(extra, tuple) or not all(
            isinstance(e, str) for e in extra):
        findings.append(Finding(
            "pack-parity", STATE_FILE,
            assign_line(src, "PACK_EXTRA_FIELDS"), 0,
            "PACK_EXTRA_FIELDS is missing (or not a literal tuple of "
            "strings) — the non-NetState packed fields must be declared",
            hint="declare the extra packed fields as a literal tuple"))
        return findings
    fields = _netstate_fields(src)
    if fields is None:
        findings.append(Finding(
            "pack-parity", STATE_FILE, line, 0,
            "NetState class not found in state.py — the packed/unpacked "
            "parity check has nothing to compare against"))
        return findings
    want = set(fields) | set(extra)
    have = set(table)
    if have != want:
        missing = sorted(want - have)
        undeclared = sorted(have - want)
        findings.append(Finding(
            "pack-parity", STATE_FILE, line, 0,
            f"PACK_LAYOUT fields and NetState + PACK_EXTRA_FIELDS "
            f"disagree (unpacked fields with no bit-field: {missing}; "
            f"packed fields neither NetState nor declared extra: "
            f"{undeclared})",
            hint="add/remove the field in PACK_LAYOUT and, for "
                 "non-NetState fields, PACK_EXTRA_FIELDS together"))
    return findings


@rule("telem-layout", "layout",
      "kernel telemetry columns must derive from the TELEM_COLS table, in "
      "the plain versions and the CUDA kernels alike")
def check_telem_layout(project: Project) -> List[Finding]:
    """The stage-counter block (SimConfig.kernel_telemetry) is the same
    silent-corruption surface as the recorder and witness blocks,
    policed the same way:

      * TELEM_COLS must exist as a pure-literal name -> (base, width)
        table, overlap-free and dense from offset 0;
      * the plain versions' ONE emission site (``_telem_block``) must key
        its value dict on exactly the table's names — removing a column
        from either side (including the last one, which density alone
        cannot see) breaks the set equality;
      * hand-numbered telemetry constants (a module-level ``*TELEM*``
        name bound to an int literal) are a finding — indices derive
        from the table (TELEM_WIDTH is computed, not hand-counted);
      * the CUDA kernels' block width and the columns they count
        (``kTelemWidth``, ``kTelemHist`` / ``kTelemQuorum`` /
        ``kTelemCoin``) equal the table's, and ``kTileWords`` — the
        plane words of the 512-lane tile the counters are kept by —
        equals ops/stream.TILE_N / state.PACK_NODES_PER_WORD.
    """
    findings: List[Finding] = []
    src = project.source(KERNEL_FILE)
    if src is None:
        return findings
    table, line, errs = _table(project, KERNEL_FILE, "TELEM_COLS",
                               rule_name="telem-layout")
    findings += errs
    if table is None:
        return findings
    findings += _check_ranges(KERNEL_FILE, line, "TELEM_COLS",
                              _by_base(table), 0,
                              rule_name="telem-layout")

    # 1. emission parity: the _telem_block value-dict keys == the table
    emit_keys = None
    emit_line = line
    for node in src.nodes:
        if isinstance(node, ast.FunctionDef) and \
                node.name == _TELEM_EMITTER:
            emit_line = node.lineno
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict) and all(
                        isinstance(k, ast.Constant) and
                        isinstance(k.value, str)
                        for k in sub.keys if k is not None):
                    keys = {k.value for k in sub.keys if k is not None}
                    if emit_keys is None or len(keys) > len(emit_keys):
                        emit_keys = keys
            break
    if emit_keys is None:
        findings.append(Finding(
            "telem-layout", KERNEL_FILE, emit_line, 0,
            f"{_TELEM_EMITTER} (the one telemetry emission site) is "
            f"missing or no longer builds its columns from a name-keyed "
            f"dict — the table-to-kernel parity check has nothing to "
            f"compare",
            hint=f"keep {_TELEM_EMITTER}' values in a dict literal keyed "
                 f"by TELEM_COLS names"))
    elif emit_keys != set(table):
        missing = sorted(set(table) - emit_keys)
        extra = sorted(emit_keys - set(table))
        findings.append(Finding(
            "telem-layout", KERNEL_FILE, emit_line, 0,
            f"TELEM_COLS and the {_TELEM_EMITTER} emission dict disagree "
            f"(declared but never emitted: {missing}; emitted but "
            f"undeclared: {extra})",
            hint="add/remove the column in BOTH the table and the "
                 "emission dict"))

    # 2. no hand-numbered telemetry column constants
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                "TELEM" in node.targets[0].id and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int):
            findings.append(Finding(
                "telem-layout", KERNEL_FILE, node.lineno, 0,
                f"hand-numbered telemetry constant "
                f"{node.targets[0].id} = {node.value.value}: telemetry "
                f"column indices must derive from the TELEM_COLS table",
                hint="derive the value from TELEM_COLS (see "
                     "TELEM_WIDTH)"))

    # 3. the CUDA kernels' counter block
    want = [("kTelemWidth", _extent(table), "TELEM_COLS's extent")]
    for col, const in (("hist_visits", "kTelemHist"),
                       ("quorum_passes", "kTelemQuorum"),
                       ("coin_draws", "kTelemCoin")):
        if col in table:
            want.append((const, table[col][0],
                         f"TELEM_COLS[{col!r}]'s column"))
    stream, state = project.source(STREAM_FILE), project.source(STATE_FILE)
    tile = literal_assign(stream, "TILE_N") if stream else None
    word = literal_assign(state, "PACK_NODES_PER_WORD") if state else None
    if isinstance(tile, int) and isinstance(word, int) and word:
        want.append(("kTileWords", tile // word,
                     "ops/stream.TILE_N / state.PACK_NODES_PER_WORD"))
    findings += _check_constants(project, "telem-layout", want)
    return findings


@rule("layout-outspec", "layout",
      "every ops/_build.SIGNATURES row must match an extern \"C\" entry "
      "point of csrc/, parameter for parameter")
def check_layout_outspec(project: Project) -> List[Finding]:
    """The kernels' C interface is the port's out_spec: ctypes passes
    each argument by the row's argtype, so a row one argtype short (or a
    pointer declared an int) shifts every later argument of the launch —
    the kernel still runs, on the wrong operands.  Every SIGNATURES row
    must name an ``extern "C"`` function with that many parameters, each
    of the same kind (pointer, int, uint32, float), and every entry
    point must have a row (an unbound entry point takes ctypes' default
    int conversion, which truncates pointers).  A type of either side
    that the reader does not know is a finding that names it, and so are
    rows with no CUDA source to hold them to."""
    rows, line, findings = _signature_rows(project)
    if rows is None:
        return findings
    if not project.cuda:
        return _no_sources(project, "layout-outspec",
                           "the SIGNATURES rows' entry points")
    entries = extern_entries(project)
    for name, (row_line, kinds) in sorted(rows.items()):
        entry = entries.get(name)
        if entry is None:
            findings.append(Finding(
                "layout-outspec", BUILD_FILE, row_line, 0,
                f"SIGNATURES row {name!r} names no extern \"C\" function "
                f"of csrc/*.cu — binding it fails at load, or binds a "
                f"stale symbol",
                hint="rename or drop the row with the entry point"))
            continue
        rel, cline, ckinds = entry
        if len(kinds) != len(ckinds):
            findings.append(Finding(
                "layout-outspec", BUILD_FILE, row_line, 0,
                f"SIGNATURES row {name!r} declares {len(kinds)} argtypes "
                f"but {rel}:{cline} takes {len(ckinds)} parameters: every "
                f"argument after the gap is passed in the wrong slot",
                hint="keep the row and the C parameter list in step"))
            continue
        for i, ((got, gtype), (want, ctype)) in enumerate(
                zip(kinds, ckinds)):
            if got is None or want is None:
                side = (f"argtype {gtype}" if got is None
                        else f"C parameter type {ctype!r} at {rel}:{cline}")
                findings.append(Finding(
                    "layout-outspec", BUILD_FILE, row_line, 0,
                    f"SIGNATURES row {name!r} argument {i}: the reader "
                    f"does not know the {side}, so it cannot hold the "
                    f"two sides to one kind",
                    hint="use a kind the reader knows (pointer, int, "
                         "uint32, float) or teach _CTYPES_KIND / _C_KIND "
                         "the type"))
            elif got != want:
                findings.append(Finding(
                    "layout-outspec", BUILD_FILE, row_line, 0,
                    f"SIGNATURES row {name!r} argument {i} is a {got} "
                    f"but {rel}:{cline} declares a {want}",
                    hint="match the argtype to the C parameter's type"))
    for name in sorted(set(entries) - set(rows)):
        rel, cline, _ = entries[name]
        findings.append(Finding(
            "layout-outspec", rel, cline, 0,
            f"extern \"C\" entry point {name} has no SIGNATURES row: "
            f"ctypes would call it with default int conversions, which "
            f"truncate pointers",
            hint=f"add {name!r} to ops/_build.SIGNATURES"))
    return findings
