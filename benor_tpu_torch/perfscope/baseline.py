"""Perf regression detection: manifest-against-baseline bands (port of
benor_tpu/perfscope/baseline.py:1-265, stdlib only).

A regression is a structural drift: a footprint metric moving outside its
band, a regime disappearing, or the deterministic round count changing.
The stage timings are machine-sensitive and gate only under an explicit
``timing_band``.  Bands gate both directions.  The logic is the JAX
package's, with two additions for documents of the two packages:

  * a port manifest names the regimes it does not capture yet
    (``unported_regimes``, regime -> the ROADMAP item); a baseline regime
    named there is reported by the caller, not gated;
  * where one document is the port's (``torch_version``) and the other the
    JAX package's, the fields the port does not measure as XLA does are
    left out by name (``NOT_MEASURED_AS_XLA``): XLA's cost model, which
    the port has not (null), its memory analysis, where the port reads the
    tensors' sizes and the caching allocator's peak, and the trace and
    compile stages, which eager torch does not have.  Two documents of one
    package compare on every field, as in the JAX package.

``check_bench_trajectory`` and the other walkers of the committed
``BENCH_r*.json`` / ``MULTICHIP_r*.json`` series are not here: they belong
to the regression gates (ROADMAP Queue A item 16e).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: metric -> max allowed new/old ratio (and 1/band on the way down).
STRUCTURAL_BANDS: Dict[str, float] = {
    "flops": 1.25,
    "bytes_accessed": 1.25,
    "transcendentals": 1.5,
    "argument_bytes": 1.25,
    "output_bytes": 1.25,
    "temp_bytes": 1.5,
    "peak_bytes": 1.5,
}

#: Stage-timing metrics (gated only when ``timing_band`` is passed).
TIMING_KEYS = ("trace_lower_s", "compile_s", "first_execute_s",
               "steady_execute_s")

#: Fields the port does not measure as XLA does: left out when a port
#: document meets a JAX package's one.
NOT_MEASURED_AS_XLA = ("flops", "bytes_accessed", "transcendentals",
                       "argument_bytes", "output_bytes", "temp_bytes",
                       "peak_bytes", "trace_lower_s", "compile_s")


class IncomparableManifests(ValueError):
    """Manifest and baseline describe different experiments (platform,
    scale or schema): the gate refuses rather than compare them."""


@dataclasses.dataclass
class Regression:
    """One out-of-band metric."""

    regime: str
    metric: str
    new: Optional[float]
    old: Optional[float]
    ratio: Optional[float]
    band: Optional[float]
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _require_comparable(new: dict, base: dict) -> None:
    for key in ("kind", "schema_version", "platform"):
        if new.get(key) != base.get(key):
            raise IncomparableManifests(
                f"{key}: manifest has {new.get(key)!r}, baseline has "
                f"{base.get(key)!r}")
    if new.get("scale") != base.get("scale"):
        raise IncomparableManifests(
            f"scale: manifest {new.get('scale')} vs baseline "
            f"{base.get('scale')} — recapture at the baseline scale or "
            f"re-baseline")


def cross_package(new: dict, base: dict) -> bool:
    """True iff one document is the port's and the other the JAX
    package's."""
    return ("torch_version" in new) != ("torch_version" in base)


def _band_check(regime: str, metric: str, new_v, old_v, band: float,
                out: List[Regression]) -> None:
    if old_v in (None, 0) or new_v is None:
        # a metric the baseline could not produce (or a zero denominator)
        # cannot band-compare; only a new zero where the baseline had
        # substance is flagged
        if old_v and not new_v:
            out.append(Regression(
                regime, metric, new_v, old_v, 0.0, band,
                f"{regime}.{metric}: went to zero (baseline {old_v}) — "
                f"the capture likely degenerated"))
        return
    ratio = float(new_v) / float(old_v)
    if ratio > band:
        out.append(Regression(
            regime, metric, float(new_v), float(old_v), round(ratio, 4),
            band,
            f"{regime}.{metric}: {new_v} vs baseline {old_v} "
            f"({ratio:.2f}x > band {band}x) — regression"))
    elif ratio < 1.0 / band:
        out.append(Regression(
            regime, metric, float(new_v), float(old_v), round(ratio, 4),
            band,
            f"{regime}.{metric}: {new_v} vs baseline {old_v} "
            f"({ratio:.2f}x < band 1/{band}x) — improvement or "
            f"degenerated capture; re-baseline if intended"))


def compare_manifests(new: dict, base: dict,
                      timing_band: Optional[float] = None
                      ) -> List[Regression]:
    """All out-of-band metrics of ``new`` against ``base`` (empty = the
    gate passes).  Raises IncomparableManifests when the two documents do
    not describe the same experiment."""
    _require_comparable(new, base)
    skip = set(NOT_MEASURED_AS_XLA) if cross_package(new, base) else set()
    unported = new.get("unported_regimes") or {}
    out: List[Regression] = []
    for regime, old_rep in base.get("regimes", {}).items():
        if regime in unported:
            continue
        new_rep = new.get("regimes", {}).get(regime)
        if new_rep is None:
            out.append(Regression(
                regime, "regime", None, None, None, None,
                f"{regime}: present in baseline but missing from the "
                f"manifest — a compiled regime disappeared"))
            continue
        if new_rep.get("rounds_executed") != old_rep.get("rounds_executed"):
            out.append(Regression(
                regime, "rounds_executed",
                new_rep.get("rounds_executed"),
                old_rep.get("rounds_executed"), None, None,
                f"{regime}.rounds_executed: "
                f"{new_rep.get('rounds_executed')} vs baseline "
                f"{old_rep.get('rounds_executed')} — same seed + scale "
                f"must execute the same rounds (determinism drift)"))
        for metric, band in STRUCTURAL_BANDS.items():
            if metric not in skip:
                _band_check(regime, metric, new_rep.get(metric),
                            old_rep.get(metric), band, out)
        if timing_band:
            for metric in TIMING_KEYS:
                if metric not in skip:
                    _band_check(regime, metric, new_rep.get(metric),
                                old_rep.get(metric), timing_band, out)
    return out


#: The bit-plane layout must cut a node's round traffic at least this much
#: at the reference geometry (max_rounds = PACKED_RATIO_REF_MAX_ROUNDS);
#: a capture's own ratio is normalized to it before the gate.
PACKED_TRAFFIC_MIN_RATIO = 4.0
PACKED_RATIO_REF_MAX_ROUNDS = 12


def _k_planes(max_rounds: int) -> int:
    """state.pack_k_bits_for, stdlib twin."""
    return max(int(max_rounds + 1).bit_length(), 1)


def normalized_traffic_ratio(fvx: dict):
    """The capture's layout re-priced at the reference geometry: old-layout
    over new-layout bytes a node per round with the k field resized to
    PACKED_RATIO_REF_MAX_ROUNDS.  None when the block lacks the packing
    fields."""
    bits = fvx.get("packed_bits_per_node")
    old_bytes = fvx.get("unpacked_round_bytes_per_node")
    mr = fvx.get("max_rounds")
    if bits is None or not old_bytes or mr is None:
        return None
    static_bits = bits - _k_planes(mr)
    ref_bits = static_bits + _k_planes(PACKED_RATIO_REF_MAX_ROUNDS)
    if ref_bits <= 0:
        return None
    return old_bytes / (2.0 * ref_bits / 8.0)


def check_fused_vs_xla(manifest: dict) -> List[str]:
    """The fused-beats-the-unfused-loop gate over a manifest's
    ``fused_vs_xla`` block: "REGRESSION: ..." strings drive exit 2,
    "note: ..." strings inform.  On the card the packed loop must beat the
    unfused one (speedup > 1.0); an ``interpret_mode`` capture (the CPU,
    where the plain versions stand in for the kernels) is held to the
    layout's packed traffic ratio instead.  A missing or null block is a
    note, never a silent pass."""
    findings: List[str] = []
    if "fused_vs_xla" not in manifest:
        findings.append("note: manifest predates the fused_vs_xla block "
                        "(schema_version < 2); fused-vs-XLA not gated")
        return findings
    fvx = manifest["fused_vs_xla"]
    if fvx is None:
        findings.append("note: fused_vs_xla is null (subset capture); "
                        "fused-vs-XLA not gated")
        return findings
    if not fvx.get("bit_equal", False):
        findings.append(
            "REGRESSION: fused_vs_xla.bit_equal is false — the fused "
            "and XLA legs diverged; the fused path is WRONG, not slow")
    ratio = normalized_traffic_ratio(fvx)
    if ratio is None or ratio < PACKED_TRAFFIC_MIN_RATIO:
        findings.append(
            f"REGRESSION: fused_vs_xla packed traffic ratio "
            f"{ratio if ratio is None else round(ratio, 4)} < "
            f"{PACKED_TRAFFIC_MIN_RATIO} at the reference geometry "
            f"(max_rounds={PACKED_RATIO_REF_MAX_ROUNDS}; the capture's "
            f"own k width is normalized out) — the bit-plane relayout "
            f"no longer cuts per-node round traffic enough (did a "
            f"field widen in state.PACK_LAYOUT?)")
    if fvx.get("interpret_mode"):
        findings.append(
            f"note: interpret-mode capture — fused/XLA speedup "
            f"{fvx.get('speedup')} measures the pallas interpreter and "
            f"is excluded from gating (the geometry-normalized traffic "
            f"ratio above carries the acceptance bound)")
        return findings
    speedup = fvx.get("speedup")
    if speedup is None or speedup <= 1.0:
        findings.append(
            f"REGRESSION: fused_vs_xla.speedup {speedup} <= 1.0 on a "
            f"real backend ({fvx.get('rounds_executed')} rounds at "
            f"N={fvx.get('n_nodes')}) — the fused fast path trails the "
            f"plain XLA loop again")
    return findings
