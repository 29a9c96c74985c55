"""benorlint core: sources, pragma suppression, findings, rule registry
(port of benor_tpu/analysis/core.py).

Dependency-free (stdlib ``ast`` and ``re`` only): the linter must run in
any environment that can parse the package, with no card and no torch
installed, and it never imports the modules it inspects (an import would
run torch's and the kernel library's set-up; a PARSE cannot).

The moving parts:

  * ``Source``     — one parsed python file: text, AST, and its pragma map.
  * ``CudaSource`` — one ``.cu`` / ``.cuh`` file under ``csrc/``, read as
    text: its comment-stripped text (line numbers kept) and its pragmas.
    The layout rules read the kernels' constants and ``extern "C"``
    entry points from it.
  * ``Project``    — every ``.py`` file under the package root and every
    CUDA source under its ``csrc/``, plus the cross-module function index
    and the device-reachable set that the tracer rules consume (built in
    ``visitors.py``).
  * ``Finding``    — one diagnostic: rule, file:line:col, message, fix hint.
  * ``@rule``      — registry decorator; ``run_rules`` executes every
    registered rule over a Project and applies pragma suppression.

Pragma syntax (the escape hatch for INTENTIONAL rule exceptions):

    # benorlint: allow-<rule> — one-line justification

On a code line it suppresses that rule's findings on that line; on a
comment-only line it covers the rest of its comment block and the first
code line after it (so a multi-line justification can sit directly above
the flagged statement).  A CUDA source takes the same pragma in a ``//``
comment.  Suppressions are counted per rule and reported — an allow
pragma is visible forever, not silent.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

#: ``# benorlint: allow-<rule>[, allow-<rule>...] — justification``
_PRAGMA_RE = re.compile(r"benorlint:\s*(allow-[a-z0-9,\s-]+)")
_ALLOW_RE = re.compile(r"allow-([a-z0-9-]+)")

#: The CUDA sources' directory, relative to the package root.
CSRC_DIR = "csrc"
_CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass
class Finding:
    """One diagnostic, anchored to a source location."""

    rule: str
    path: str          # repo/package-relative path
    line: int
    col: int
    message: str
    hint: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pragma_map(lines: List[str], comment: str) -> Dict[int, set]:
    """line (1-based) -> the rule names allowed on it, for comments that
    start with ``comment`` (``#`` in python, ``//`` in CUDA)."""
    pragmas: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        rules = set(_ALLOW_RE.findall(m.group(1)))
        if not rules:
            continue
        pragmas.setdefault(i, set()).update(rules)
        if line.lstrip().startswith(comment):
            # comment-only pragma: cover the rest of the comment block
            # and the first code line after it
            j = i + 1
            while j <= len(lines) and (
                    not lines[j - 1].strip()
                    or lines[j - 1].lstrip().startswith(comment)):
                pragmas.setdefault(j, set()).update(rules)
                j += 1
            pragmas.setdefault(j, set()).update(rules)
    return pragmas


class Source:
    """One parsed python file + its pragma map."""

    def __init__(self, path: str, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.lines = text.splitlines()
        #: line (1-based) -> set of rule names allowed on that line
        self.pragmas: Dict[int, set] = _pragma_map(self.lines, "#")

    @functools.cached_property
    def nodes(self) -> list:
        """Every node of the tree in ``ast.walk`` order, walked once and
        shared by the index and every rule."""
        return list(ast.walk(self.tree))

    def allows(self, rule: str, line: int) -> bool:
        return rule in self.pragmas.get(line, ())


_CUDA_COMMENT_RE = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"', re.S)


def strip_cuda_comments(text: str) -> str:
    """``text`` with every ``//`` and ``/* */`` comment blanked out, each
    newline kept (so an offset still maps to its line); string literals
    are left as they are (``extern "C"`` stays readable)."""
    def blank(m):
        s = m.group(0)
        if s.startswith('"'):
            return s
        return re.sub(r"[^\n]", " ", s)
    return _CUDA_COMMENT_RE.sub(blank, text)


class CudaSource:
    """One CUDA source read as text: its comment-stripped code and its
    pragma map (``// benorlint: allow-<rule>``)."""

    def __init__(self, path: str, rel: str, text: str) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.code = strip_cuda_comments(text)
        self.pragmas: Dict[int, set] = _pragma_map(self.lines, "//")

    def line_of(self, offset: int) -> int:
        """1-based line of a character offset into ``code``."""
        return self.code.count("\n", 0, offset) + 1

    def allows(self, rule: str, line: int) -> bool:
        return rule in self.pragmas.get(line, ())


class Project:
    """Every parsed source under one package root, plus the shared
    analyses (function index, device reachability) rules consume."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.sources: Dict[str, Source] = {}          # rel path -> Source
        #: the CUDA sources under csrc/, rel path -> CudaSource
        self.cuda: Dict[str, CudaSource] = {}
        #: files that failed to parse, as findings (a broken file must
        #: surface as a diagnostic, not crash the run off the 0/2
        #: exit contract)
        self.errors: List[Finding] = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root).replace(os.sep, "/")
                if fn.endswith(_CUDA_SUFFIXES) and \
                        rel.startswith(CSRC_DIR + "/"):
                    with open(full, encoding="utf-8") as fh:
                        self.cuda[rel] = CudaSource(full, rel, fh.read())
                    continue
                if not fn.endswith(".py"):
                    continue
                with open(full, encoding="utf-8") as fh:
                    text = fh.read()
                try:
                    self.sources[rel] = Source(full, rel, text)
                except SyntaxError as e:
                    self.errors.append(Finding(
                        "parse-error", rel, e.lineno or 1,
                        (e.offset or 1) - 1,
                        f"file does not parse: {e.msg}",
                        hint="benorlint analyzes the AST; fix the "
                             "syntax error first"))

    @functools.cached_property
    def index(self):
        """The module/import index and the device-reachable set
        (visitors.py), built on first use: the layout and config rules
        read tables only and never pay for it."""
        from .visitors import build_index
        return build_index(self)

    def source(self, rel: str) -> Optional[Source]:
        return self.sources.get(rel)

    def cuda_source(self, rel: str) -> Optional[CudaSource]:
        return self.cuda.get(rel)


@dataclasses.dataclass
class Rule:
    name: str
    family: str      # 'tracer' | 'layout' | 'config' | 'perf' | 'serve'
    doc: str
    check: Callable[["Project"], List[Finding]]


#: name -> Rule, in registration order.
RULES: "Dict[str, Rule]" = {}


def rule(name: str, family: str, doc: str):
    """Register a rule.  The wrapped function takes a Project and returns
    a list of Findings (pragma suppression is applied by run_rules)."""
    def wrap(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name=name, family=family, doc=doc, check=fn)
        return fn
    return wrap


def run_rules(project: Project, names=None
              ) -> Tuple[List[Finding], Dict[str, int]]:
    """Run the (selected) rules -> (active findings, suppressed counts).

    A finding is suppressed when its file carries a matching
    ``# benorlint: allow-<rule>`` pragma on the finding's line (or the
    comment block directly above it).  Findings are deduplicated by
    (rule, location, message) first, and each deduped finding is counted
    once, active or suppressed.  (Distinct messages at one location are
    distinct findings — config-parity anchors one finding per missing
    regime at the field's first sim.py use.)"""
    # rule modules register on import; import them here so a bare
    # ``from .core import run_rules`` is enough to get the full set
    from . import (rules_config, rules_layout,  # noqa: F401
                   rules_manifest, rules_perf, rules_serve,
                   rules_tracer)

    active: List[Finding] = list(project.errors)
    suppressed: Dict[str, int] = {}
    for name, r in RULES.items():
        if names is not None and name not in names:
            continue
        seen = set()
        for f in r.check(project):
            key = (f.rule, f.path, f.line, f.col, f.message)
            if key in seen:
                continue
            seen.add(key)
            src = project.source(f.path) or project.cuda_source(f.path)
            if src is not None and src.allows(f.rule, f.line):
                suppressed[f.rule] = suppressed.get(f.rule, 0) + 1
            else:
                active.append(f)
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return active, suppressed


# --------------------------------------------------------------------------
# Small shared AST helpers (used by every rule family)
# --------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def literal_assign(source: Source, name: str):
    """The literal value of a module-level ``NAME = <literal>`` assignment
    (ast.literal_eval'd), or None when absent / not a pure literal.

    This is how the layout checker reads the declarative column tables:
    by PARSING them, never by importing the modules that own them — which
    also forces the tables to stay machine-readable pure literals."""
    node = assign_node(source, name)
    if node is None:
        return None
    try:
        return ast.literal_eval(node.value)
    except (ValueError, TypeError):
        return None


def assign_node(source: Source, name: str):
    """The first module-level ``Assign`` / ``AnnAssign`` binding ``name``,
    or None."""
    for node in source.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            targets = [node.target.id]
        if name in targets:
            return node
    return None


def assign_line(source: Source, name: str) -> int:
    """Line of a module-level assignment to ``name`` (1 when absent)."""
    for node in source.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.lineno
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.target.id == name:
            return node.lineno
    return 1
