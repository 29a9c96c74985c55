"""Serve regression gate: band-compare two serve manifests (port of
benor_tpu/serve/gate.py).

STANDARD LIBRARY ONLY: it loads by file path (importlib) with nothing but
the standard library, so a manifest can be gated against the committed
SERVE_BASELINE.json without torch, as the port's other gates load
(atlas/gate.py, kernelscope/gate.py, sweepscope/gate.py).  The rules,
bands and messages are the JAX package's.

What gates by default (structural, machine-insensitive):

  * ``errors``                 any client error is a regression — the
                               request plane's first contract is that
                               every accepted job completes
  * ``jobs_completed``         must equal ``jobs_submitted`` (a leaked
                               batch slot is a serving bug even when no
                               client noticed)
  * ``jobs_per_launch``        the coalescing efficiency — the number
                               serving exists to produce.  A ratio at
                               or below 1.0 where the baseline
                               amortized launches is the WORST
                               collapse (the request plane degenerated
                               to per-job dispatch); otherwise it bands
                               at ``COALESCING_BAND`` of baseline.
  * ``attribution.ok``         servescope's completeness cross-check:
                               the per-stage means must telescope to
                               the client mean latency within
                               ``ATTRIBUTION_BAND``.  A manifest whose
                               attribution broke is hiding where the
                               time went — structural, so it gates
                               unconditionally.
  * stage p99s                 ``stages.queue_wait.p99`` and
                               ``stages.launch.p99`` band against the
                               baseline at ``STAGE_P99_BANDS`` (a
                               generous ratio, and only when the
                               regression exceeds
                               ``MIN_STAGE_DELTA_MS`` — these are the
                               two stages whose blowups are SERVING
                               bugs, a starved batcher or a collapsed
                               executor, rather than machine noise).

Wall-clock metrics (p50/p99 latency, throughput) are carried for trend
reading and gate only under an explicit ``timing_band`` — shared CI
machines make them noisy, exactly like the perf gate's stage timings.
The two default-gated stage p99s trade that caution for coverage via
the wide band + absolute-delta floor.

Comparability (``IncomparableServe``, never a confident verdict; the
CLI's ``load`` reports it and exits 0, as the JAX CLI): kind/schema_version
mismatch, different platform, different job scale block, or a manifest
driven with fewer clients than the baseline (latency at 100 clients
says nothing about saturation at 1000).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: Floor on new/baseline jobs-per-launch ratio before it counts as a
#: coalescing regression.
COALESCING_BAND = 0.8

#: How far the stage-mean sum may drift from the client mean latency
#: before the attribution is considered incomplete (|coverage-1| <=
#: band).  The slack absorbs what the server legitimately cannot stamp:
#: connection setup and the wire time outside accepted->done.
ATTRIBUTION_BAND = 0.25

#: Default stage-p99 ceilings vs baseline: new_p99 regresses when it
#: exceeds band x baseline AND the delta clears MIN_STAGE_DELTA_MS.
STAGE_P99_BANDS = {"queue_wait": 2.0, "launch": 2.0}

#: Absolute floor under which a stage-p99 blowup is ignored (2x of
#: nothing is noise, not a regression).
MIN_STAGE_DELTA_MS = 50.0

#: Schema version this comparator understands (v2 = stage latencies +
#: attribution; a v1 manifest predates servescope and cannot be gated
#: honestly against a v2 baseline).
SCHEMA_VERSION = 2


class IncomparableServe(Exception):
    """The two manifests cannot be honestly compared."""


@dataclasses.dataclass
class ServeFinding:
    """One gated regression."""

    metric: str
    message: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _require(manifest: Dict, name: str) -> Dict:
    if not isinstance(manifest, dict) or \
            manifest.get("kind") != "serve_manifest":
        raise IncomparableServe(f"{name} is not a serve manifest "
                                f"(kind={manifest.get('kind')!r})")
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise IncomparableServe(
            f"{name} schema_version {manifest.get('schema_version')!r} "
            f"!= {SCHEMA_VERSION}")
    return manifest


def compare_serve(manifest: Dict, baseline: Dict,
                  coalescing_band: float = COALESCING_BAND,
                  timing_band: Optional[float] = None,
                  stage_bands: Optional[Dict[str, float]] = None
                  ) -> List[ServeFinding]:
    """New manifest vs baseline -> regression findings (empty = in-band).

    Raises IncomparableServe when a verdict would be dishonest (see
    module docstring); the CLI maps that to exit 3.
    """
    _require(manifest, "manifest")
    _require(baseline, "baseline")
    for key in ("platform",):
        if manifest.get(key) != baseline.get(key):
            raise IncomparableServe(
                f"{key} differs: {manifest.get(key)!r} vs baseline "
                f"{baseline.get(key)!r} — recapture on the baseline "
                f"platform or re-baseline")
    if manifest.get("scale") != baseline.get("scale"):
        raise IncomparableServe(
            f"job scale differs: {manifest.get('scale')} vs baseline "
            f"{baseline.get('scale')}")
    if manifest.get("clients", 0) < baseline.get("clients", 0):
        raise IncomparableServe(
            f"manifest drove {manifest.get('clients')} clients, baseline "
            f"{baseline.get('clients')} — saturation metrics at lower "
            f"concurrency are not comparable")

    findings: List[ServeFinding] = []
    errors = manifest.get("errors", 0)
    if errors:
        findings.append(ServeFinding(
            "errors", f"{errors} of {manifest.get('clients')} clients "
                      f"errored (baseline serves every accepted job)"))
    if manifest.get("jobs_completed") != manifest.get("jobs_submitted"):
        findings.append(ServeFinding(
            "jobs_completed",
            f"completed {manifest.get('jobs_completed')} of "
            f"{manifest.get('jobs_submitted')} submitted jobs — a batch "
            f"slot leaked"))
    new_jpl = float(manifest.get("jobs_per_launch") or 0.0)
    base_jpl = float(baseline.get("jobs_per_launch") or 0.0)
    if base_jpl > 1.0 and new_jpl <= 1.0:
        findings.append(ServeFinding(
            "jobs_per_launch",
            f"coalescing collapsed to {new_jpl:.3f} jobs/launch "
            f"(baseline {base_jpl:.3f}): the request plane degenerated "
            f"to per-job dispatch — the worst serving collapse"))
    elif base_jpl > 0 and new_jpl < base_jpl * coalescing_band:
        findings.append(ServeFinding(
            "jobs_per_launch",
            f"coalescing {new_jpl:.3f} < {coalescing_band} x baseline "
            f"{base_jpl:.3f} jobs/launch"))
    attr = manifest.get("attribution") or {}
    if not attr.get("ok", False):
        findings.append(ServeFinding(
            "attribution",
            f"stage attribution incomplete: stage means sum to "
            f"{attr.get('stage_mean_sum_ms')} ms vs client mean "
            f"{attr.get('client_mean_ms')} ms (coverage "
            f"{attr.get('coverage')}, band {attr.get('band')}) — a "
            f"transition went unstamped, the timeline is lying by "
            f"omission"))
    for stage, band in (STAGE_P99_BANDS if stage_bands is None
                        else stage_bands).items():
        new_p99 = float((manifest.get("stages") or {})
                        .get(stage, {}).get("p99") or 0.0)
        base_p99 = float((baseline.get("stages") or {})
                         .get(stage, {}).get("p99") or 0.0)
        if (new_p99 > base_p99 * band
                and new_p99 - base_p99 > MIN_STAGE_DELTA_MS):
            findings.append(ServeFinding(
                f"stages.{stage}.p99",
                f"{stage} p99 {new_p99:.1f} ms > {band} x baseline "
                f"{base_p99:.1f} ms (delta over the "
                f"{MIN_STAGE_DELTA_MS:.0f} ms noise floor) — the "
                f"request plane's {stage} stage regressed"))
    if timing_band is not None:
        thr = float(manifest.get("throughput_jobs_per_sec") or 0.0)
        base_thr = float(baseline.get("throughput_jobs_per_sec") or 0.0)
        if base_thr > 0 and thr < base_thr * timing_band:
            findings.append(ServeFinding(
                "throughput_jobs_per_sec",
                f"throughput {thr:.2f} < {timing_band} x baseline "
                f"{base_thr:.2f} jobs/s"))
        p99 = float((manifest.get("latency_ms") or {}).get("p99") or 0.0)
        base_p99 = float((baseline.get("latency_ms") or {}).get("p99")
                         or 0.0)
        if base_p99 > 0 and p99 * timing_band > base_p99:
            findings.append(ServeFinding(
                "latency_ms.p99",
                f"p99 latency {p99:.1f} ms > baseline {base_p99:.1f} ms "
                f"/ band {timing_band}"))
    return findings
