"""benorlint — project-native static analysis for the benor_tpu_torch tree
(port of benor_tpu/analysis).

An AST-based rule framework (visitor core + registry + ``Finding``
objects with file:line anchors and fix hints + ``# benorlint:
allow-<rule>`` pragma suppression) with rule families, each grounded in
a silent-corruption class the port has to manage by hand.
``python -m benor_tpu_torch lint`` runs them all (exit 2 on findings)
with no device; tests/test_torch_lint.py keeps the shipped tree
lint-clean.

Rule families -> the incident each one prevents in the port:

**Device-path hygiene** (rules_tracer.py).  Eager torch has no trace
boundary, so the device path is the set of functions reachable from
sim.DEVICE_ROOTS, the per-round work the two host loops launch
(visitors.py).  The loops read the unsettled count once a round by
design (ROADMAP "Known differences"); one more read inside the round is
a second sync a round, which empties the card's queue — ``host-sync``
flags ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
``int()``/``float()``/``bool()`` of a tensor parameter, ``np.asarray``
and ``torch.cuda.synchronize()`` there; ``traced-branch`` flags the
hidden sync of a Python ``if``/``while`` on a tensor.  ``host-rng``
flags ``np.random.*`` and torch's global-generator samplers without
``generator=``: every draw of the port is a threefry stream keyed on
(seed, round, phase, trial, node), equal on the card, the CPU and the
JAX package.  ``dtype-drift`` flags float64 (the f32 math rounds op for
op as XLA's; int64 is the documented bit-work width).  ``rng-fold``
enforces ops/rng.py's one-fold_in-chain-per-use key discipline, and
``broad-except`` flags handlers that would hide a kernel build or launch
failure — the port's no-fallback guard.

**Kernel column layout** (rules_layout.py).  The recorder, the witness
and the stage counters ride extra columns of the round kernels'
partials, and the CUDA kernels know each column as a bare ``constexpr``
that only a comment ties to its table (csrc/round_body.cuh).
``layout-overlap`` / ``pack-layout`` prove the tables disjoint and
dense, ``layout-parity`` / ``pack-parity`` / ``telem-layout`` prove
them equal across state.py, ops/packed_round.py and the CUDA constants,
and ``layout-outspec`` holds every ops/_build.SIGNATURES row to its
``extern "C"`` entry point, parameter for parameter (a ctypes arity
mismatch shifts every later argument silently).

**Serve-plane liveness** (rules_serve.py).  One blocking call or device
sync inside an ``async def`` of the request plane stalls every SSE
stream at once: ``serve-blocking-call``.

**Build observability** (rules_perf.py).  The kernel library's builds
and loads are counted by ops/_build.py (``library_events``: the
``compile_count`` of the sweep engine and the serve executors, and
perfscope's ``compile_s``); ``perf-unregistered-build`` flags a
``ctypes.CDLL``, a compiler subprocess or a ``cpp_extension`` build
elsewhere, with the pure-literal ``LIBRARY_REGISTRY`` as the reviewed
exception list — cross-checked for staleness by the same rule.

**Config parity** (rules_config.py, rules_manifest.py).  A SimConfig
field consumed in sim.py must reach every regime of the port (the sweep
engine and the packed round) or carry a reasoned PARITY_ALLOWLIST entry:
``config-parity``.  Every emitted ``*_manifest`` kind must have a
registered checker in the repo's tools/check_metrics_schema.py:
``manifest-kind-parity``.

The JAX package's ``donate-argnums`` is not ported (eager torch has no
buffer donation) and its ``perf-unregistered-jit`` becomes
``perf-unregistered-build``.  The framework is stdlib-only and reads
every table by PARSING source — linting never imports (or executes) the
modules under inspection, nor compiles the CUDA sources.
"""

# the rule modules register on import: RULES is whole once this package is
from . import (rules_config, rules_layout, rules_manifest,  # noqa: F401
               rules_perf, rules_serve, rules_tracer)
from .cli import LintReport, default_root, run_lint
from .core import Finding, Project, RULES, run_rules, rule

__all__ = ["Finding", "LintReport", "Project", "RULES", "default_root",
           "rule", "run_lint", "run_rules"]
