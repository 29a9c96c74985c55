"""kernelscope — the round kernels' interior, observed (port of
benor_tpu/kernelscope/).

The stage counters (``SimConfig(kernel_telemetry=True)``, kept by the
round kernels' armed twins) count each stage's work a 512-lane tile:
lanes active and padded, sampler draws, histogram visits, quorum passes,
coin draws and plane-stack passes.  report.py turns the accumulator into
per-stage blocks and ratios; capture.py runs both dispatches of the
packed round (the fused kernel, the two-kernel pair) telemetry off and on,
prices them with the traffic model (perfscope/roofline.py) and on the
card times their kernels; the manifest (manifest.py) is compared against
the committed ``KERNEL_BASELINE.json`` by gate.py.  ``capture`` is
imported on first use.
"""

from .gate import (KernelFinding, IncomparableKernels,  # noqa: F401
                   compare_kernels)
from .manifest import (KERNEL_MANIFEST_KIND,  # noqa: F401
                       build_kernel_manifest, load_kernel_manifest,
                       save_kernel_manifest)
from .report import (KERNEL_TELEM_KIND, pad_waste_frac,  # noqa: F401
                     stage_report)


def capture_kernels(**kw):
    """The capture (see capture.py), imported on first use."""
    from .capture import capture_kernels as _capture

    return _capture(**kw)
