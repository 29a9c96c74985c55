"""Kernel-manifest band comparator (port of
benor_tpu/kernelscope/gate.py).

What gates against a baseline at the same scale and platform:

  * a kernel the baseline measured that vanished from the manifest;
  * its dispatch changing (the measured kernel is not the pinned one);
  * a stage counter drifting: they are deterministic integers, so any
    drift means the kernel interior changed work;
  * the pad-waste fraction growing past PAD_WASTE_SLACK;
  * the predicted/measured byte ratio leaving BYTE_RATIO_BAND, or
    vanishing;
  * a fused-vs-XLA pair whose legs stopped being bit-equal.

Scale or platform mismatch is incomparable, never a silent pass.  The
byte ratio prices the predicted bytes against XLA's cost model, which the
port does not have: where one document is the port's (``torch_version``)
and the other the JAX package's, it is left out; two documents of one
package compare on every check, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

#: Multiplicative band for the predicted/measured byte ratio, both
#: directions (measured cost models wobble across jax versions; the
#: counters do not, so only the ratio gets a band).
BYTE_RATIO_BAND = 2.0

#: Absolute slack on the pad-waste fraction before growth regresses
#: (a new geometry legitimately moves it; same-scale captures may not).
PAD_WASTE_SLACK = 0.02

#: Fields whose per-kernel values must match EXACTLY at the same
#: scale/seed (deterministic integers measured in-kernel).
EXACT_COUNTER_STAGES = ("proposal", "vote")


class IncomparableKernels(Exception):
    """Baseline and manifest measure different platforms/scales."""


@dataclasses.dataclass
class KernelFinding:
    kind: str
    message: str

    def to_dict(self) -> dict:
        return {"kind": self.kind, "message": self.message}


def _require_comparable(manifest: dict, baseline: dict) -> None:
    for key in ("platform", "interpret"):
        if manifest.get(key) != baseline.get(key):
            raise IncomparableKernels(
                f"{key}: manifest {manifest.get(key)!r} vs baseline "
                f"{baseline.get(key)!r}")
    if manifest.get("scale") != baseline.get("scale"):
        raise IncomparableKernels(
            f"scale: manifest {manifest.get('scale')} vs baseline "
            f"{baseline.get('scale')}")


def compare_kernels(manifest: dict, baseline: dict,
                    ratio_band: float = BYTE_RATIO_BAND
                    ) -> List[KernelFinding]:
    """Findings = regressions of ``manifest`` against ``baseline``
    (empty list = in-band).  Raises IncomparableKernels on a
    platform/scale mismatch."""
    _require_comparable(manifest, baseline)
    # one document the port's, the other the JAX package's
    skip_ratio = ("torch_version" in manifest) != ("torch_version"
                                                   in baseline)
    findings: List[KernelFinding] = []
    base_k = baseline.get("kernels", {})
    new_k = manifest.get("kernels", {})
    for name in sorted(base_k):
        if name not in new_k:
            findings.append(KernelFinding(
                "missing-kernel",
                f"kernel {name!r} present in the baseline but absent "
                f"from the manifest — its dispatch no longer runs (or "
                f"the capture silently dropped it)"))
            continue
        b, m = base_k[name], new_k[name]
        if m.get("dispatch") != b.get("dispatch"):
            findings.append(KernelFinding(
                "dispatch-drift",
                f"{name}: dispatch {m.get('dispatch')!r} != baseline "
                f"{b.get('dispatch')!r} — the measured kernel is not "
                f"the one the baseline pinned"))
            continue
        for stage in EXACT_COUNTER_STAGES:
            bc = b.get("stages", {}).get(stage, {}).get("counters", {})
            mc = m.get("stages", {}).get(stage, {}).get("counters", {})
            if bc != mc:
                drift = {k: (bc.get(k), mc.get(k))
                         for k in set(bc) | set(mc)
                         if bc.get(k) != mc.get(k)}
                findings.append(KernelFinding(
                    "counter-drift",
                    f"{name}.{stage}: stage counters drifted at the "
                    f"same scale/seed (baseline, new): {drift} — the "
                    f"kernel interior changed work without a "
                    f"re-baseline"))
        bw, mw = b.get("pad_waste_frac"), m.get("pad_waste_frac")
        if bw is not None and mw is not None and \
                mw > bw + PAD_WASTE_SLACK:
            findings.append(KernelFinding(
                "pad-waste-regression",
                f"{name}: pad_waste_frac {mw:.4f} grew past baseline "
                f"{bw:.4f} + {PAD_WASTE_SLACK} — the padding waste the "
                f"re-tiling work is meant to shrink got worse"))
        if skip_ratio:
            continue
        br, mr = b.get("byte_ratio"), m.get("byte_ratio")
        if br and mr:
            rel = mr / br
            if rel > ratio_band or rel < 1.0 / ratio_band:
                findings.append(KernelFinding(
                    "byte-ratio-regression",
                    f"{name}: predicted/measured byte ratio {mr:.4f} "
                    f"is {rel:.2f}x the baseline's {br:.4f} (band "
                    f"{ratio_band}x) — the layout tables and the "
                    f"executable's cost model stopped telescoping"))
        elif br and not mr:
            findings.append(KernelFinding(
                "byte-ratio-regression",
                f"{name}: baseline measured a byte ratio ({br:.4f}) "
                f"but the manifest has none — the cost-model "
                f"cross-check vanished"))
    fvx_b = baseline.get("fused_vs_xla")
    fvx_m = manifest.get("fused_vs_xla")
    if fvx_b is not None:
        if fvx_m is None:
            findings.append(KernelFinding(
                "fused-vs-xla-missing",
                "baseline carries a fused_vs_xla pair but the manifest "
                "does not — the gap attribution vanished"))
        elif not fvx_m.get("bit_equal", False):
            findings.append(KernelFinding(
                "fused-vs-xla-diverged",
                "fused_vs_xla.bit_equal is false — the fused and "
                "baseline legs no longer agree, so the byte/stage "
                "attribution is meaningless"))
    return findings
