"""Perf-observability rule: every kernel-library build and load goes
through the funnel (the port's counterpart of the JAX package's
``perf-unregistered-jit``, benor_tpu/analysis/rules_perf.py).

The JAX package makes every compiled executable observable through its
perfscope funnel.  The port compiles no executable: its compile is the
kernel library's build (an ``nvcc`` run) and load (the library opened and
bound), and its funnel is ops/_build.py, whose ``compile_library`` /
``load_library`` count ``library_events`` — the number that
``compile_count``, the serve executors' ``executor_compiles`` and
perfscope's ``compile_s`` / ``backend_compiles`` read.  A
``ctypes.CDLL``, a ``subprocess`` run of a compiler (``nvcc``, ``g++``)
or a ``torch.utils.cpp_extension`` build anywhere else escapes that
count: a build the gates cannot see, and a second library whose kernels
no launch counter and no ``chip_smoke.py`` check covers.

``perf-unregistered-build`` makes that a lint failure.  Two escape
hatches, both visible:

  * ``LIBRARY_REGISTRY`` in ops/_build.py — the pure-literal roster of
    the reviewed functions outside the funnel that build or load a
    library (module-relative names, the JAX package's ``JIT_REGISTRY``
    key space).  This rule re-parses the tuple (never imports it) and
    cross-checks that every entry still resolves to a real function, so
    the roster cannot go stale and silently allow-list nothing.
  * the standard ``# benorlint: allow-perf-unregistered-build`` pragma —
    the sanctioned spelling for throwaway builds in test/fixture trees.

ops/_build.py itself is exempt (it IS the funnel).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .core import (Finding, Project, Source, assign_line, dotted_name,
                   literal_assign, rule)
from .visitors import _canonical

#: The funnel module, relative to the lint root (benor_tpu_torch/).
_FUNNEL_REL = "ops/_build.py"

#: The roster literal the rule re-parses out of the funnel module.
_REGISTRY_NAME = "LIBRARY_REGISTRY"

#: Calls that open a shared library.
_LOADS = {"ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
          "ctypes.CDLL.LoadLibrary"}

#: subprocess calls that run a program.
_RUNS = {"subprocess.run", "subprocess.Popen", "subprocess.call",
         "subprocess.check_call", "subprocess.check_output"}

#: Program names that make a subprocess run a build.
_COMPILERS = {"nvcc", "g++", "gcc", "c++", "cc", "clang", "clang++"}

_HINT = ("route it through ops/_build.py (compile_library / load_library "
         "count library_events), add the function to LIBRARY_REGISTRY "
         "with its justification, or pragma throwaway test-tree builds")


def _module_key(rel: str) -> str:
    """`ops/hist.py` -> `ops.hist` (the LIBRARY_REGISTRY key space: module
    path relative to the package root, no package name)."""
    parts = rel[:-3].split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _load_registry(project: Project) -> Tuple[Optional[Source], tuple]:
    """(funnel Source, parsed roster) — (None, ()) when the project has no
    funnel module (fixture trees): every build is then unregistered by
    definition."""
    src = project.source(_FUNNEL_REL)
    if src is None:
        return None, ()
    roster = literal_assign(src, _REGISTRY_NAME)
    if not isinstance(roster, tuple):
        return src, None
    return src, roster


def _runs_compiler(call: ast.Call, fn: ast.AST) -> bool:
    """True when a subprocess call runs a compiler: its command is a list
    whose program names one, or a command built elsewhere (a variable) in
    a function that names one."""
    cmd = call.args[0] if call.args else None
    if isinstance(cmd, (ast.List, ast.Tuple)) and cmd.elts:
        return _mentions_compiler(cmd.elts[0])
    return _mentions_compiler(fn)


def _mentions_compiler(fn: ast.AST) -> bool:
    """True when a node names a compiler: holds a string constant that is
    (or ends in the path of) one, or a name containing ``nvcc``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value.rsplit("/", 1)[-1] in _COMPILERS:
                return True
        name = dotted_name(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if name and "nvcc" in name.lower():
            return True
    return False


def _build_calls(project: Project, rel: str, src: Source):
    """(call node, enclosing function or None, what) for every library
    build or load in one file."""
    idx = project.index
    module = idx.module_of[rel]
    defs = [n for n in src.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def owner(call):
        """The innermost def whose lines hold ``call``, or None."""
        inside = [d for d in defs
                  if d.lineno <= call.lineno <= d.end_lineno]
        return max(inside, key=lambda d: d.lineno) if inside else None

    for node in src.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if not name:
            continue
        canon = _canonical(module, idx, name)
        if not canon.startswith(("ctypes.", "subprocess.", "torch.utils.")):
            continue
        fn = owner(node)
        what = None
        if canon in _LOADS:
            what = f"{canon}(...) opens a shared library"
        elif canon.startswith("torch.utils.cpp_extension."):
            what = f"{canon}(...) builds a torch extension"
        elif canon in _RUNS and _runs_compiler(
                node, fn if fn is not None else src.tree):
            what = f"{canon}(...) runs a compiler"
        if what is not None:
            yield node, fn, what


@rule("perf-unregistered-build", "perf",
      "kernel-library build or load outside the ops/_build.py funnel "
      "(invisible to library_events, compile_count and the gates)")
def check_unregistered_build(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    funnel, roster = _load_registry(project)

    if funnel is not None:
        line = assign_line(funnel, _REGISTRY_NAME)
        if roster is None:
            findings.append(Finding(
                "perf-unregistered-build", _FUNNEL_REL, line, 0,
                f"{_REGISTRY_NAME} is missing from {_FUNNEL_REL} (or no "
                f"longer a pure-literal tuple) — the reviewed exception "
                f"list cannot be read",
                hint="declare LIBRARY_REGISTRY as a tuple of "
                     "module-relative function names"))
            roster = ()
        # the roster itself must not go stale: an entry whose module or
        # function is gone allow-lists nothing and hides that it does
        for entry in roster:
            mod, _, fn = str(entry).rpartition(".")
            rel = mod.replace(".", "/") + ".py"
            src = project.source(rel)
            if src is None:
                findings.append(Finding(
                    "perf-unregistered-build", _FUNNEL_REL, line, 0,
                    f"{_REGISTRY_NAME} entry {entry!r} names module {rel} "
                    f"which is not in the tree — a stale roster row "
                    f"allow-lists nothing",
                    hint="update or drop the entry (the roster is the "
                         "reviewed exception list; it must stay real)"))
                continue
            if not any(isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                       and n.name == fn for n in src.nodes):
                findings.append(Finding(
                    "perf-unregistered-build", _FUNNEL_REL, line, 0,
                    f"{_REGISTRY_NAME} entry {entry!r} does not resolve "
                    f"to a function in {rel} — a stale roster row "
                    f"allow-lists nothing",
                    hint="update or drop the entry (the roster is the "
                         "reviewed exception list; it must stay real)"))

    allowed: Set[str] = set(roster or ())
    for rel, src in project.sources.items():
        if rel == _FUNNEL_REL:
            continue
        mod_key = _module_key(rel)
        for node, fn, what in _build_calls(project, rel, src):
            entry = f"{mod_key}.{fn.name}" if fn is not None else mod_key
            if entry in allowed:
                continue
            findings.append(Finding(
                "perf-unregistered-build", rel, node.lineno,
                node.col_offset,
                f"{what} outside {_FUNNEL_REL} ({entry!r} is not in "
                f"{_REGISTRY_NAME}): the build escapes library_events, "
                f"so compile_count and the gates cannot see it",
                hint=_HINT))
    return findings
