"""Cross-module function index + device-reachability analysis (port of
benor_tpu/analysis/visitors.py).

The tracer-hygiene rules (rules_tracer.py) need to know which functions
run ON THE DEVICE PATH — the per-round work the host loops launch, round
after round — because a host sync that is fine in harness code
(``int(out[0])`` as a completion barrier in sweep.run_point) stalls the
card once a round inside it.

The JAX package seeds this set from its trace boundaries (``jax.jit``,
``pallas_call``, ``shard_map``, the ``lax`` loops).  Eager torch has no
trace boundary, so only the seeds change:

  seeds        the pure-literal roster ``DEVICE_ROOTS`` in sim.py:
               module-relative names (``ops.packed_round.packed_round``,
               the key space of the JAX package's ``JIT_REGISTRY``) of
               the per-round functions that the host loops
               (``ops.packed_round.run_packed_slice``,
               ``sim._unfused_slice``) call.  The roster is read by
               PARSING sim.py; an entry that no longer resolves is a
               finding (``host-sync`` reports it), as a stale
               ``JIT_REGISTRY`` row is one.
  propagation  a call from a reachable function marks the callee
               reachable, resolved through each module's import-alias
               table (plain names, one-level ``alias.name`` attributes,
               and relative imports); nested ``def``s of a reachable
               function are reachable; so is the first argument of a
               ``functools.partial`` made inside one.
  host escape  functions handed to a ``callback`` / ``pure_callback`` /
               ``io_callback`` run on the HOST by construction and are
               never marked.

Unresolvable calls (methods on unknown receivers, dynamic dispatch) are
skipped — the analysis under-approximates rather than guessing, so its
findings stay actionable.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import Project, assign_line, dotted_name, literal_assign

#: Where the roster of device roots lives, package-root-relative.
ROOTS_FILE = "sim.py"

#: The roster literal the analysis re-parses out of ROOTS_FILE.
ROOTS_NAME = "DEVICE_ROOTS"

#: Registering a function here hands it to the HOST runtime.
_HOST_SINKS = {"callback", "pure_callback", "io_callback"}


@dataclasses.dataclass
class FuncInfo:
    module: str                  # dotted module, e.g. benor_tpu_torch.ops.rng
    name: str
    rel: str                     # source path relative to the root
    node: ast.AST                # FunctionDef / AsyncFunctionDef
    params: Tuple[str, ...]


class Index:
    """Function defs, import aliases, and the reachable set for one
    Project.  ``traced`` keeps the JAX package's name for the set."""

    def __init__(self) -> None:
        self.funcs: Dict[Tuple[str, str], FuncInfo] = {}
        self.aliases: Dict[str, Dict[str, str]] = {}   # module -> alias map
        self.module_of: Dict[str, str] = {}            # rel path -> module
        self.traced: List[FuncInfo] = []
        #: DEVICE_ROOTS problems: (line in ROOTS_FILE, message) — a
        #: missing or non-literal roster, or an entry that resolves to no
        #: function of the tree
        self.root_errors: List[Tuple[int, str]] = []
        self._traced_ids: Set[int] = set()
        self._host_ids: Set[int] = set()
        self._subtrees: Dict[int, list] = {}

    def subtree(self, node: ast.AST) -> list:
        """``list(ast.walk(node))``, walked once per node and cached."""
        out = self._subtrees.get(id(node))
        if out is None:
            out = self._subtrees[id(node)] = list(ast.walk(node))
        return out

    def is_traced(self, node: ast.AST) -> bool:
        return id(node) in self._traced_ids


def _module_name(root_pkg: str, rel: str) -> str:
    parts = rel[:-3].split("/")                        # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([root_pkg] + parts) if parts else root_pkg


def _collect_aliases(module: str, nodes) -> Dict[str, str]:
    """alias -> dotted target, from every import at any depth (``nodes``:
    the module's walked nodes)."""
    out: Dict[str, str] = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = module.split(".")
                base = base[:len(base) - node.level]
                src = ".".join(base + ([node.module] if node.module else []))
            else:
                src = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{src}.{a.name}" if src else a.name
    return out


def _params(node) -> Tuple[str, ...]:
    a = node.args
    names = [p.arg for p in
             getattr(a, "posonlyargs", []) + a.args + a.kwonlyargs]
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            names.append(extra.arg)
    return tuple(names)


def _canonical(source_module: str, idx: "Index", name: str) -> str:
    """Resolve the first component of a dotted name through the module's
    alias table: ``F.pad`` -> ``torch.nn.functional.pad``."""
    head, _, rest = name.partition(".")
    target = idx.aliases.get(source_module, {}).get(head)
    if target is None:
        return name
    return f"{target}.{rest}" if rest else target


def _is_partial(module: str, idx: "Index", node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name is None:
        return False
    return _canonical(module, idx, name).split(".")[-1] == "partial"


def resolve_call(idx: "Index", module: str,
                 func_node: ast.AST) -> Optional[FuncInfo]:
    """FuncInfo for a call target, through the alias table; None when the
    target is not a statically resolvable project function."""
    name = dotted_name(func_node)
    if name is None:
        return None
    if "." not in name:
        alias = idx.aliases.get(module, {}).get(name)
        if alias and "." in alias:
            mod, _, fn = alias.rpartition(".")
            return idx.funcs.get((mod, fn))
        return idx.funcs.get((module, name))
    head, _, rest = name.partition(".")
    if "." in rest:                  # method chains / deep attrs: skip
        return None
    target = idx.aliases.get(module, {}).get(head)
    if target is None:
        return None
    return idx.funcs.get((target, rest))


def _callable_args(call: ast.Call):
    """The argument expressions of a call that may carry function refs."""
    return list(call.args) + [k.value for k in call.keywords]


def _seed_roots(project: Project, idx: Index, root_pkg: str,
                seeds: List[FuncInfo]) -> None:
    """Seed the reachable set from ROOTS_FILE's DEVICE_ROOTS roster.  A
    tree without ROOTS_FILE (a fixture tree) has no roots and no
    finding; a ROOTS_FILE without a pure-literal tuple of names, or an
    entry that names no function of the tree, is recorded in
    ``idx.root_errors`` — a rule must never go blind silently."""
    src = project.source(ROOTS_FILE)
    if src is None:
        return
    roster = literal_assign(src, ROOTS_NAME)
    line = assign_line(src, ROOTS_NAME)
    if not isinstance(roster, tuple) or not all(
            isinstance(e, str) for e in roster):
        idx.root_errors.append((line, (
            f"{ROOTS_NAME} is missing from {ROOTS_FILE} (or no longer a "
            f"pure-literal tuple of names) — the device-reachable set "
            f"has no seeds and the tracer rules see nothing")))
        return
    for entry in roster:
        mod, _, fn = entry.rpartition(".")
        module = ".".join(p for p in (root_pkg, mod) if p)
        info = idx.funcs.get((module, fn))
        if info is None:
            idx.root_errors.append((line, (
                f"{ROOTS_NAME} entry {entry!r} does not resolve to a "
                f"function of the tree — a stale root seeds nothing")))
        else:
            seeds.append(info)


def build_index(project: Project) -> Index:
    """Build the function index, alias tables and reachable set."""
    idx = Index()
    root_pkg = project.root.rstrip("/").split("/")[-1]

    for rel, src in project.sources.items():
        module = _module_name(root_pkg, rel)
        idx.module_of[rel] = module
        idx.aliases[module] = _collect_aliases(module, src.nodes)
        for node in src.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx.funcs[(module, node.name)] = FuncInfo(
                    module=module, name=node.name, rel=rel, node=node,
                    params=_params(node))

    seeds: List[FuncInfo] = []
    _seed_roots(project, idx, root_pkg, seeds)
    for rel, src in project.sources.items():
        module = idx.module_of[rel]
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            canon = _canonical(module, idx, name) if name else ""
            if canon.split(".")[-1] in _HOST_SINKS:
                for ref in _callable_args(node):
                    info = None
                    if isinstance(ref, (ast.Name, ast.Attribute)):
                        info = resolve_call(idx, module, ref)
                    if info is not None:
                        idx._host_ids.add(id(info.node))

    # worklist propagation: reachable -> callees, partial targets, nested
    # defs
    work = list(seeds)
    while work:
        info = work.pop()
        if id(info.node) in idx._traced_ids or \
                id(info.node) in idx._host_ids:
            continue
        idx._traced_ids.add(id(info.node))
        idx.traced.append(info)
        for node in idx.subtree(info.node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not info.node:
                nested = idx.funcs.get((info.module, node.name))
                if nested is not None and nested.node is node:
                    work.append(nested)
            elif isinstance(node, ast.Call):
                target = resolve_call(idx, info.module, node.func)
                if target is not None:
                    work.append(target)
                if _is_partial(info.module, idx, node) and node.args:
                    first = node.args[0]
                    if isinstance(first, (ast.Name, ast.Attribute)):
                        target = resolve_call(idx, info.module, first)
                        if target is not None:
                            work.append(target)
    idx.traced.sort(key=lambda f: (f.rel, f.node.lineno))
    return idx
