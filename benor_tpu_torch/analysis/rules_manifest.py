"""Manifest-contract rule: every emitted manifest kind has a checker
(port of benor_tpu/analysis/rules_manifest.py, unchanged in behaviour).

The repo's committed-artifact discipline is that every pinned-schema
document (``kind: perf_manifest`` / ``scaling_manifest`` /
``serve_manifest`` / ``sweep_manifest``) is auto-detected and
cross-field-validated by ``tools/check_metrics_schema.py`` — that is
what makes a hand-edited baseline or a drifted capture fail CI instead
of silently gating vacuously.  Nothing STOPPED a new subsystem from
emitting a fifth ``"<x>_manifest"`` kind with no registered checker:
its documents would flow through the tool's fall-through branch as a
bench record, error confusingly, and the contract would rot.

``manifest-kind-parity`` makes that a lint failure, parsed from BOTH
sides and never imported (the linter's no-import contract):

  * the EMISSION side: every ``"kind": "<x>_manifest"`` dict-literal
    entry and every ``<NAME>_KIND = "<x>_manifest"`` module constant
    anywhere in the package tree — the two spellings the shipped
    manifest writers use (serve/loadgen.py inlines the dict entry;
    perfscope/manifest.py, kernelscope/manifest.py and
    sweepscope/manifest.py bind a ``*_KIND`` constant).  Mere
    identifier-shaped strings (``__all__`` rosters of
    ``save_sweep_manifest``-style function names) are not emissions
    and do not count;
  * the REGISTRY side: the pure-literal ``MANIFEST_CHECKERS`` dict in
    ``tools/check_metrics_schema.py`` (the same dispatch ``main`` runs,
    so "registered" means "runnable").  Like ops/_build's LIBRARY_REGISTRY,
    the registry is STALENESS-CHECKED: a row whose checker function no
    longer exists in the tool validates nothing and must say so rather
    than rot silently.

The tools file lives OUTSIDE the package root (the repo's ``tools/``,
benor_tpu_torch/'s sibling; the port writes the JAX package's documents,
and that tool validates both packages' until the port has a checker of
its own); a fixture tree without it treats every emitted kind as
unregistered — the same missing-funnel behavior as
``perf-unregistered-build``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .core import Finding, Project, rule

#: A whole-string manifest kind: lowercase snake segments ending in
#: ``_manifest`` (matches the value domain of MANIFEST_CHECKERS keys).
_KIND_RE = re.compile(r"\A[a-z0-9]+(?:_[a-z0-9]+)*_manifest\Z")

#: The checker registry's home, relative to the lint root's PARENT
#: (the repo layout: benor_tpu_torch/ and tools/ are siblings).
_TOOLS_REL = os.path.join("tools", "check_metrics_schema.py")

_REGISTRY_NAME = "MANIFEST_CHECKERS"

_HINT = ("register the kind in tools/check_metrics_schema.py "
         "MANIFEST_CHECKERS with a check_<x>_manifest function (schema "
         "file + cross-field pins), like the perf/scaling/serve/sweep "
         "manifests")


def _tools_path(project: Project) -> str:
    return os.path.join(os.path.dirname(project.root), _TOOLS_REL)


def _parse_registry(path: str):
    """(registry dict, assignment line, parsed tool AST) from the tools
    file — ({}, 1, None) when the file or the literal is missing (every
    emitted kind is then unregistered by definition)."""
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return {}, 1, None
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            targets = [node.target.id]
        if _REGISTRY_NAME in targets:
            try:
                value = ast.literal_eval(node.value)
            except (ValueError, TypeError):
                return {}, node.lineno, tree
            if isinstance(value, dict):
                return value, node.lineno, tree
            return {}, node.lineno, tree
    return {}, 1, tree


def _kind_literal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and _KIND_RE.match(node.value):
        return node.value
    return None


def _emitted_kinds(project: Project) -> Dict[str, Tuple[str, int, int]]:
    """kind -> first (rel, line, col) where an EMISSION appears, in
    sorted file order (deterministic anchors for dedup + mutation
    tests).  Emissions are ``{"kind": "<x>_manifest", ...}`` dict
    entries and ``<NAME>_KIND = "<x>_manifest"`` module constants (see
    module docstring)."""
    kinds: Dict[str, Tuple[str, int, int]] = {}

    def record(value_node) -> None:
        kind = _kind_literal(value_node)
        if kind is not None and kind not in kinds:
            kinds[kind] = (rel, value_node.lineno,
                           value_node.col_offset)

    for rel in sorted(project.sources):
        src = project.sources[rel]
        for node in src.nodes:
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and \
                            k.value == "kind":
                        record(v)
            elif isinstance(node, ast.Assign):
                if node.value is not None and any(
                        isinstance(t, ast.Name)
                        and t.id.endswith("KIND")
                        for t in node.targets):
                    record(node.value)
            elif isinstance(node, ast.AnnAssign):
                if node.value is not None and \
                        isinstance(node.target, ast.Name) and \
                        node.target.id.endswith("KIND"):
                    record(node.value)
    return kinds


@rule("manifest-kind-parity", "config",
      "a \"<x>_manifest\" kind emitted without a registered checker in "
      "tools/check_metrics_schema.py (or a stale registry row)")
def check_manifest_kind_parity(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    tools_path = _tools_path(project)
    tools_disp = os.path.relpath(tools_path, project.root)
    registry, reg_line, tool_tree = _parse_registry(tools_path)
    kinds = _emitted_kinds(project)

    for kind in sorted(kinds):
        rel, line, col = kinds[kind]
        if kind not in registry:
            missing = ("tools/check_metrics_schema.py is not in the "
                       "tree" if tool_tree is None else
                       f"{_REGISTRY_NAME} registers no checker for it")
            findings.append(Finding(
                "manifest-kind-parity", rel, line, col,
                f"manifest kind {kind!r} is emitted here but {missing} "
                f"— its documents would dodge schema + cross-field "
                f"validation and the committed-artifact contract rots",
                hint=_HINT))

    # staleness (the LIBRARY_REGISTRY discipline): a registry row whose
    # checker function left the tool validates nothing — and must say
    # so rather than rot silently
    if tool_tree is not None:
        defined = {n.name for n in ast.walk(tool_tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        for kind in sorted(registry):
            fn = registry[kind]
            if not isinstance(fn, str) or fn not in defined:
                findings.append(Finding(
                    "manifest-kind-parity", tools_disp, reg_line, 0,
                    f"{_REGISTRY_NAME} entry {kind!r} -> {fn!r} does "
                    f"not resolve to a function in "
                    f"check_metrics_schema.py — a stale registry row "
                    f"validates nothing",
                    hint="update or drop the row (the registry is the "
                         "tool's live dispatch; it must stay real)"))
    return findings
