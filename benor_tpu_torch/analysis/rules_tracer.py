"""Tracer-hygiene rules on the device path: host syncs, host RNG, tensor
branches, float drift, PRNG-key discipline and broad handlers (port of
benor_tpu/analysis/rules_tracer.py).

Every rule here is grounded in a hazard this repo has to manage (see
analysis/__init__ for the incident map).  The device-path scope comes
from visitors.build_index, seeded by sim.DEVICE_ROOTS: a host sync in
harness code is a completion barrier; the SAME call inside a function
the round loops reach is one device->host round trip a round, which
empties the card's queue every round.

The JAX package's ``donate-argnums`` is not ported, by design: eager
torch has no buffer donation (ROADMAP "Not to port, by design").
"""

from __future__ import annotations

import ast
from typing import Dict, List

from .core import Finding, Project, dotted_name, rule
from .visitors import ROOTS_FILE, _canonical

#: Tensor methods that copy a device value to the host (a sync each).
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

#: Calls that block the host on the device.
_SYNC_CALLS = {"torch.cuda.synchronize"}

#: 64-bit FLOAT spellings: the f32 math must round op for op as XLA's
#: does (the kernels are built -fmad=false for it), and a float64 anywhere
#: on the device path rounds differently and runs at a fraction of the
#: f32 rate.  int64 is NOT flagged: it is the port's documented width for
#: plain bit work (threefry words masked to 32 bits, ROADMAP "Known
#: differences"), so flagging it would flag every plain version.
_WIDE_DTYPES = {"torch.float64", "torch.double", "np.float64",
                "numpy.float64"}

#: Methods that convert a tensor to float64.
_WIDE_METHODS = ("double",)

#: torch's samplers that draw from the process-global generator unless a
#: ``generator=`` is passed.
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                   "multinomial", "normal", "poisson", "rand_like",
                   "randn_like", "randint_like"}

#: The in-place samplers of a tensor (global generator without
#: ``generator=``).
_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                     "exponential_", "geometric_", "cauchy_",
                     "log_normal_"}

#: The port's draws of ops/rng.py that take a key as their first argument.
_KEY_DRAWS = {"_bits", "_uniform", "_bernoulli", "grid_keys"}

#: The key combinators of ops/rng.py whose index arguments (all but the
#: key) must be single components, never an arithmetic product.
_FOLD_CALLS = {"fold_in", "round_key", "grid_keys"}

#: torch calls that return Python values, never a tensor: a branch on them
#: is host logic, not a device read.
_HOST_VALUED = ("torch.is_", "torch.are_", "torch.get_", "torch.cuda.",
                "torch.device", "torch.Size", "torch.iinfo", "torch.finfo",
                "torch.backends.")


def _parents(nodes) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in nodes:
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _canon(project: Project, rel: str, name: str) -> str:
    """Alias-canonical dotted name — ONE resolver (visitors._canonical)
    serves both the reachability analysis and every rule's matching, so
    the two can never disagree about what a name refers to."""
    idx = project.index
    return _canonical(idx.module_of[rel], idx, name)


def _is_np(project: Project, rel: str, name: str) -> bool:
    return _canon(project, rel, name).startswith("numpy.")


def _traced_walk(project: Project):
    """(FuncInfo, node) pairs over every reachable function's subtree.

    Each node is yielded ONCE, attributed to its innermost reachable
    function (nested defs are visited before their parents, whose walks
    then skip the already-claimed subtree) — so one violation is one
    finding, named after the function that actually contains it."""
    seen = set()
    for info in sorted(project.index.traced,
                       key=lambda f: (f.rel, -f.node.lineno)):
        for node in project.index.subtree(info.node):
            if id(node) in seen:
                continue
            seen.add(id(node))
            yield info, node


def _guarded_by_isinstance(parents: Dict[int, ast.AST], node: ast.AST,
                           name: str) -> bool:
    """True when an ancestor If/IfExp tests ``isinstance(name, ...)`` —
    the host-int-or-tensor dispatch idiom."""
    cur = node
    while id(cur) in parents:
        cur = parents[id(cur)]
        if isinstance(cur, (ast.If, ast.IfExp)):
            for sub in ast.walk(cur.test):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id == "isinstance" and sub.args and \
                        isinstance(sub.args[0], ast.Name) and \
                        sub.args[0].id == name:
                    return True
    return False


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


@rule("host-sync", "tracer",
      "host synchronization inside a device-path function")
def check_host_sync(project: Project) -> List[Finding]:
    findings = [Finding(
        "host-sync", ROOTS_FILE, line, 0, message,
        hint="keep sim.DEVICE_ROOTS a pure-literal tuple of "
             "module-relative function names that exist")
        for line, message in project.index.root_errors]
    parent_cache: Dict[str, Dict[int, ast.AST]] = {}
    for info, node in _traced_walk(project):
        if not isinstance(node, ast.Call):
            continue
        # x.item() / .tolist() / .cpu() / .numpy(): a device->host copy
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args and \
                not node.keywords:
            findings.append(Finding(
                "host-sync", info.rel, node.lineno, node.col_offset,
                f".{node.func.attr}() inside device-path function "
                f"{info.name!r} forces a device->host sync per call",
                hint="keep the value on the device (a 0-dim tensor) or "
                     "fetch it once in the host loop"))
            continue
        name = dotted_name(node.func)
        if name and _canon(project, info.rel, name) in _SYNC_CALLS:
            findings.append(Finding(
                "host-sync", info.rel, node.lineno, node.col_offset,
                f"{name}() inside device-path function {info.name!r} "
                f"blocks the host on the whole device queue",
                hint="synchronize only where a clock is read, in the "
                     "harness"))
            continue
        # np.asarray / np.array on a tensor materializes it on the host
        if name and _is_np(project, info.rel, name) and \
                _canon(project, info.rel, name).split(".")[-1] in \
                ("asarray", "array"):
            findings.append(Finding(
                "host-sync", info.rel, node.lineno, node.col_offset,
                f"np.{name.split('.')[-1]}() inside device-path function "
                f"{info.name!r} pulls its operand to the host",
                hint="use torch.as_tensor on the device, or pragma when "
                     "the operand is static config-only host data"))
            continue
        # int()/float()/bool() on a parameter of the device-path function
        if isinstance(node.func, ast.Name) and \
                node.func.id in ("int", "float", "bool") and \
                len(node.args) == 1:
            arg = node.args[0]
            target = arg
            if isinstance(target, ast.Subscript):
                target = target.value
            if isinstance(target, ast.Name) and \
                    target.id in info.params:
                parents = parent_cache.setdefault(
                    info.rel, _parents(project.source(info.rel).nodes))
                if _guarded_by_isinstance(parents, node, target.id):
                    continue    # host-int-or-tensor dispatch idiom
                findings.append(Finding(
                    "host-sync", info.rel, node.lineno, node.col_offset,
                    f"{node.func.id}() on parameter "
                    f"{target.id!r} of device-path function "
                    f"{info.name!r} is a blocking fetch when it holds a "
                    f"device tensor",
                    hint="keep the value a tensor, or take it as a "
                         "host int where the caller already has one"))
    return findings


@rule("host-rng", "tracer",
      "host-side numpy RNG or torch's global generator (non-reproducible "
      "across devices and layouts)")
def check_host_rng(project: Project) -> List[Finding]:
    findings = []
    for rel, src in project.sources.items():
        for node in src.nodes:
            if isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if not name:
                    continue
                canon = _canon(project, rel, name)
                if canon.startswith("numpy.random") and \
                        not isinstance(node.ctx, ast.Store):
                    findings.append(Finding(
                        "host-rng", rel, node.lineno, node.col_offset,
                        "np.random draws do not key on (seed, round, "
                        "phase, trial, node) and cannot reproduce across "
                        "devices and layouts (ops/rng.py contract)",
                        hint="derive draws from ops/rng.py's fold_in "
                             "chains, or pragma seeded host-side input "
                             "generation"))
            elif isinstance(node, ast.Call) and not _has_generator(node):
                name = dotted_name(node.func)
                canon = _canon(project, rel, name) if name else ""
                parts = canon.split(".")
                inplace = isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _INPLACE_SAMPLERS
                if inplace or (len(parts) == 2 and parts[0] == "torch"
                               and parts[1] in _TORCH_SAMPLERS):
                    what = (f".{node.func.attr}()" if inplace
                            else f"{canon}()")
                    findings.append(Finding(
                        "host-rng", rel, node.lineno, node.col_offset,
                        f"{what} without generator= draws from torch's "
                        f"process-global generator: the draw keys on "
                        f"nothing of (seed, round, phase, trial, node) "
                        f"and differs between the card and the CPU",
                        hint="derive draws from ops/rng.py's threefry "
                             "chains, or pass a seeded generator= for "
                             "host-side inputs"))
    # one finding per chain: np.random.default_rng yields nested
    # Attribute nodes ("np.random", "np.random.default_rng") that share
    # a start location
    uniq = {}
    for f in findings:
        uniq[(f.path, f.line, f.col)] = f
    return list(uniq.values())


def _tensor_valued(project: Project, rel: str, name: str) -> bool:
    canon = _canon(project, rel, name)
    return canon.startswith("torch.") and \
        not canon.startswith(_HOST_VALUED)


@rule("traced-branch", "tracer",
      "Python control flow on a tensor value in a device-path function")
def check_traced_branch(project: Project) -> List[Finding]:
    findings = []
    for info, node in _traced_walk(project):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        offender = None
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call):
                name = dotted_name(sub.func)
                if name and _tensor_valued(project, info.rel, name):
                    offender = name
                    break
                if isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in ("any", "all") and not sub.args:
                    offender = f".{sub.func.attr}()"
                    break
        if offender is not None:
            kw = "if" if isinstance(node, ast.If) else "while"
            findings.append(Finding(
                "traced-branch", info.rel, node.lineno, node.col_offset,
                f"Python `{kw}` on a tensor expression ({offender}) in "
                f"{info.name!r}: on the card every evaluation is a hidden "
                f"device->host sync, once a round",
                hint="use torch.where / masked arithmetic, or decide on "
                     "host ints the caller already holds"))
    return findings


@rule("dtype-drift", "tracer",
      "64-bit float on the device path (the f32 math must round as XLA's)")
def check_dtype_drift(project: Project) -> List[Finding]:
    findings = []
    for info, node in _traced_walk(project):
        name = None
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name not in _WIDE_DTYPES:
                continue
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _WIDE_METHODS and not node.args:
            name = f".{node.func.attr}()"
        else:
            continue
        findings.append(Finding(
            "dtype-drift", info.rel, node.lineno, node.col_offset,
            f"{name} in device-path function {info.name!r}: the port's "
            f"float math is f32, rounded op for op as the JAX package's "
            f"XLA (the kernels build -fmad=false for it) — a float64 "
            f"step rounds differently and runs at a fraction of the f32 "
            f"rate",
            hint="use torch.float32 on the device; 64-bit floats belong "
                 "to host-side summaries only"))
    return findings


def _product_in(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult)
               for sub in ast.walk(node))


@rule("rng-fold", "tracer",
      "PRNG key use off the chained fold_in discipline")
def check_rng_fold(project: Project) -> List[Finding]:
    findings = []
    for rel, src in project.sources.items():
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            last = _canon(project, rel, name).split(".")[-1]
            if last in _FOLD_CALLS and \
                    any(_product_in(a) for a in node.args[1:]):
                findings.append(Finding(
                    "rng-fold", rel, node.lineno, node.col_offset,
                    f"{last} of an arithmetic index product: flat ids "
                    f"like trial*N+node collide across shapes and "
                    f"overflow the 32-bit counter word at 1M x 1M scale "
                    f"— fold each component in its own chained fold_in "
                    f"(ops/rng.py)",
                    hint="fold_in(fold_in(key, trial), node)"))
    # drawing straight from the run's base key, key_words(seed), with no
    # per-round/phase fold
    for info, node in _traced_walk(project):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = dotted_name(node.func)
        key_arg = node.args[0]
        if not name or not isinstance(key_arg, ast.Call):
            continue
        last = _canon(project, info.rel, name).split(".")[-1]
        inner = dotted_name(key_arg.func) or ""
        if last in _KEY_DRAWS and inner.split(".")[-1] == "key_words":
            findings.append(Finding(
                "rng-fold", info.rel, node.lineno, node.col_offset,
                f"{last} drawn directly from the run's base key in "
                f"{info.name!r}: every call site shares one stream "
                f"(ops/rng.py requires exactly one fold_in chain per use)",
                hint="key on (round, phase, ids) via "
                     "rng.round_key/grid_keys before drawing"))
    return findings


@rule("broad-except", "tracer",
      "broad exception handler (silently eats kernel build and launch "
      "failures)")
def check_broad_except(project: Project) -> List[Finding]:
    findings = []
    for rel, src in project.sources.items():
        for node in src.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name) and
                node.type.id in ("Exception", "BaseException"))
            if broad:
                findings.append(Finding(
                    "broad-except", rel, node.lineno, node.col_offset,
                    "except Exception swallows kernel build and launch "
                    "failures indistinguishably from real errors — "
                    "around a build or a launch it is a silent fallback "
                    "that hides the device",
                    hint="catch the specific exception, or pragma "
                         "best-effort boundaries with a justification"))
    return findings
