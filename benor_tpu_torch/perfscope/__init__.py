"""perfscope — the port's performance observatory (port of
benor_tpu/perfscope/).

Each regime the port runs is captured stage by stage (the kernel
library's build and load, the first and the steady executions, timed to a
device synchronize), with its memory footprint (the tensors' sizes, the
caching allocator's peak on the card) and one ``torch.profiler`` pass on
the card (device busy share, the port's kernel launches by name, the top
device entries): capture.py.  roofline.py holds the card's peaks, the
packing cost model, the port's traffic and op-count models and the
roofline placement; manifest.py the JSON document; baseline.py (stdlib
only) the comparison against a committed baseline.  ``python -m
benor_tpu_torch profile`` drives them.

Not ported, by design: the JAX package's ``instrument.py``
(``instrumented_jit``, ``aot_compile``, ``cost_of``), which wraps
``jax.jit`` and XLA's ahead-of-time compile: eager torch has neither, and
no executable cost model (ROADMAP).
"""

import importlib

from .baseline import (IncomparableManifests, Regression,
                       STRUCTURAL_BANDS, compare_manifests)
from .roofline import peaks_for, roofline

# capture.py and manifest.py load torch, and manifest.py regimes.py with
# it; they are imported on first use, so the stdlib comparator and the
# cost models load without them.
_LAZY = {
    "PerfReport": "capture", "REPORT_VERSION": "capture",
    "build_report": "capture", "capture_stages": "capture",
    "profile_pass": "capture",
    "MANIFEST_KIND": "manifest", "build_manifest": "manifest",
    "load_manifest": "manifest", "missing_regimes": "manifest",
    "save_manifest": "manifest",
    "capture_regime": "regimes", "capture_all": "regimes",
}

__all__ = sorted([
    "IncomparableManifests", "Regression", "STRUCTURAL_BANDS",
    "compare_manifests", "peaks_for", "roofline", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
