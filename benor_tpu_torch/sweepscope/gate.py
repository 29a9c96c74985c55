"""The sweep engine's bucket-stage model and the sweep manifest's gate
(port of benor_tpu/sweepscope/gate.py, stdlib only).

The model: the strictly serial wall of a run's measured stage clocks, the
wall of the ideal compile-ahead / execute-behind pipeline over them, and
the headroom between the two.  A bucket's stages are ``prepare_s`` and
``compile_s`` (host work; in the port the build leg's kernel-library load),
``run_s`` (device work) and ``fetch_s`` (host work a pipeline drains off
the critical path).

The gate (``compare_sweep``) holds a manifest against a baseline at the
same platform and scale: the overlap headroom's share of the serial wall
may not grow past HEADROOM_BAND x the baseline's (over the
HEADROOM_FRAC_SLACK noise floor), the compile count may not grow, a
pipelined run must reclaim at least RECLAIM_MIN_FRAC of a modeled
headroom above RECLAIM_MODEL_FLOOR_S (and not collapse RECLAIM_BAND below
a pipelined baseline's), and the stage clocks must cover at least
TELESCOPE_MIN of the wall.  ``wall_s`` gates only under an explicit
``timing_band``.  Another platform, scale or schema is incomparable."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: Ratio band on the headroom fraction vs baseline before it counts as
#: a serialization regression.
HEADROOM_BAND = 1.5

#: Absolute noise floor on the headroom-fraction delta (1.5x of nearly
#: nothing is timer jitter, not a regression).
HEADROOM_FRAC_SLACK = 0.15

#: Minimum fraction of the sweep wall clock the per-bucket stage clocks
#: must account for (the telescoping band; the remainder is bucketing /
#: input-build overhead outside any stage).
TELESCOPE_MIN = 0.7

#: Stage-clock sums may exceed the wall only by timer noise (serial
#: dispatch; a pipelined sweep legitimately exceeds it — see
#: :func:`telescope_max`).
TELESCOPE_MAX = 1.05

#: The reclaimed-headroom checks arm only when the serial model shows at
#: least this much absolute headroom: below it (CPU smoke captures sit
#: in the tens of milliseconds) "reclaimed ~ 0" is timer noise, not a
#: dead pipeline.
RECLAIM_MODEL_FLOOR_S = 0.5

#: A pipelined run must reclaim at least this fraction of the modeled
#: headroom once the floor arms — reclaimed ~ 0 where the serial model
#: shows substantive overlap means the async dispatch serialized.
RECLAIM_MIN_FRAC = 0.25

#: Ratio band on headroom_reclaimed_frac vs the baseline's before the
#: drop counts as a pipeline collapse.
RECLAIM_BAND = 3.0

#: Schema version this comparator understands: v2 manifests carry a
#: ``pipeline`` block (pipelined flag, bucket-loop span, modeled against
#: reclaimed headroom).
SCHEMA_VERSION = 2

#: The four bucket lifecycle stages, in execution order.  ``prepare``
#: and ``compile`` are host work, ``run`` is device work, ``fetch`` is
#: host work that an async pipeline drains off the critical path.
STAGES = ("prepare_s", "compile_s", "run_s", "fetch_s")


class IncomparableSweep(Exception):
    """The two manifests cannot be honestly compared."""


@dataclasses.dataclass
class SweepFinding:
    """One gated regression."""

    metric: str
    message: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def serial_s(buckets: List[dict]) -> float:
    """Every stage of every bucket, summed: the strictly serial wall."""
    return float(sum(sum(float(b.get(s) or 0.0) for s in STAGES)
                     for b in buckets))


def ideal_pipeline_s(buckets: List[dict]) -> float:
    """The wall of the ideal pipeline over the measured stages: the host
    prepares and builds bucket after bucket, the device runs each once its
    build has landed and the previous run has ended, and a bucket's fetch
    drains beside later builds.  Never above ``serial_s`` (equal for one
    bucket)."""
    host = 0.0          # host cursor: prepare + compile in bucket order
    device = 0.0        # device cursor: runs back to back
    end = 0.0
    for b in buckets:
        host += float(b.get("prepare_s") or 0.0)
        host += float(b.get("compile_s") or 0.0)
        start = max(host, device)
        device = start + float(b.get("run_s") or 0.0)
        end = max(end, device + float(b.get("fetch_s") or 0.0))
    return float(max(end, host))


def overlap_headroom_s(buckets: List[dict]) -> float:
    """The wall an ideal pipeline would reclaim from the serial schedule
    (>= 0)."""
    return max(0.0, serial_s(buckets) - ideal_pipeline_s(buckets))


def headroom_reclaimed_s(buckets: List[dict], span_s: float) -> float:
    """The overlap a measured bucket loop achieved: ``serial_s`` less the
    loop's wall ``span_s`` (the work the four stage clocks cover, and
    nothing else), clamped at 0."""
    return max(0.0, serial_s(buckets) - float(span_s))


def telescope_max(manifest: Dict) -> float:
    """Upper telescoping band for this manifest.

    Serial dispatch: stage sums may exceed the wall only by timer noise
    (``TELESCOPE_MAX``).  Pipelined dispatch overlaps host compile with
    device execute, so the stage SUM legitimately exceeds the shrunken
    wall — but never beyond the fully-overlapped bound
    ``serial_s / ideal_pipeline_s`` (plus the same noise factor)."""
    pipe = manifest.get("pipeline") or {}
    if not pipe.get("pipelined"):
        return TELESCOPE_MAX
    buckets = manifest.get("buckets") or []
    ideal = ideal_pipeline_s(buckets)
    if ideal <= 0.0:
        return TELESCOPE_MAX
    return (serial_s(buckets) / ideal) * TELESCOPE_MAX


def _require(manifest: Dict, name: str) -> Dict:
    if not isinstance(manifest, dict) or \
            manifest.get("kind") != "sweep_manifest":
        raise IncomparableSweep(f"{name} is not a sweep manifest "
                                f"(kind={manifest.get('kind')!r})")
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise IncomparableSweep(
            f"{name} schema_version {manifest.get('schema_version')!r} "
            f"!= {SCHEMA_VERSION}")
    return manifest


def compare_sweep(manifest: Dict, baseline: Dict,
                  headroom_band: float = HEADROOM_BAND,
                  timing_band: Optional[float] = None
                  ) -> List[SweepFinding]:
    """New manifest vs baseline -> regression findings (empty = in-band).

    Raises IncomparableSweep when a verdict would be dishonest (see
    module docstring); the CLI maps that to exit 3.
    """
    _require(manifest, "manifest")
    _require(baseline, "baseline")
    if manifest.get("platform") != baseline.get("platform"):
        raise IncomparableSweep(
            f"platform differs: {manifest.get('platform')!r} vs baseline "
            f"{baseline.get('platform')!r} — recapture on the baseline "
            f"platform or re-baseline")
    if manifest.get("scale") != baseline.get("scale"):
        raise IncomparableSweep(
            f"sweep scale differs: {manifest.get('scale')} vs baseline "
            f"{baseline.get('scale')}")

    findings: List[SweepFinding] = []
    hr = manifest.get("overlap_headroom_frac")
    base_hr = baseline.get("overlap_headroom_frac")
    if not isinstance(hr, (int, float)) or isinstance(hr, bool):
        findings.append(SweepFinding(
            "overlap_headroom_frac",
            f"overlap headroom missing/non-numeric ({hr!r}): the "
            f"pipeline attribution vanished — the worst observability "
            f"collapse, nothing prices item 4's async dispatch anymore"))
    elif isinstance(base_hr, (int, float)) and \
            not isinstance(base_hr, bool):
        if (hr > base_hr * headroom_band
                and hr - base_hr > HEADROOM_FRAC_SLACK):
            findings.append(SweepFinding(
                "overlap_headroom_frac",
                f"serialized-pipeline regression: overlap headroom "
                f"fraction {hr:.3f} > {headroom_band} x baseline "
                f"{base_hr:.3f} (delta over the {HEADROOM_FRAC_SLACK} "
                f"noise floor) — the sweep spends relatively more wall "
                f"clock with the host or device idle"))
    new_cc = manifest.get("compile_count")
    base_cc = baseline.get("compile_count")
    if isinstance(new_cc, int) and isinstance(base_cc, int) and \
            new_cc > base_cc:
        findings.append(SweepFinding(
            "compile_count",
            f"{new_cc} backend compiles vs baseline {base_cc} at the "
            f"same scale — the bucketing regressed toward "
            f"compile-per-point"))
    pipe = manifest.get("pipeline")
    base_pipe = baseline.get("pipeline") or {}
    if not isinstance(pipe, dict):
        findings.append(SweepFinding(
            "pipeline",
            f"pipeline block missing/malformed ({pipe!r}): a v2 "
            f"manifest must report whether dispatch was pipelined and "
            f"what it reclaimed"))
    else:
        model = pipe.get("headroom_model_s")
        reclaimed_frac = pipe.get("headroom_reclaimed_frac")
        model_num = isinstance(model, (int, float)) and \
            not isinstance(model, bool)
        frac_num = isinstance(reclaimed_frac, (int, float)) and \
            not isinstance(reclaimed_frac, bool)
        if pipe.get("pipelined") and model_num and \
                model >= RECLAIM_MODEL_FLOOR_S:
            if not frac_num:
                findings.append(SweepFinding(
                    "pipeline.headroom_reclaimed_frac",
                    f"pipelined manifest reports no reclaimed-headroom "
                    f"fraction ({reclaimed_frac!r}) against a "
                    f"{model:.2f}s serial model — the pipeline's whole "
                    f"before/after number vanished"))
            elif reclaimed_frac < RECLAIM_MIN_FRAC:
                findings.append(SweepFinding(
                    "pipeline.headroom_reclaimed_frac",
                    f"pipelined dispatch reclaimed {reclaimed_frac:.3f} "
                    f"of a {model:.2f}s modeled headroom "
                    f"(< {RECLAIM_MIN_FRAC}): the compile-ahead thread "
                    f"is serializing against execute"))
            elif base_pipe.get("pipelined"):
                base_frac = base_pipe.get("headroom_reclaimed_frac")
                if (isinstance(base_frac, (int, float))
                        and not isinstance(base_frac, bool)
                        and base_frac > 0
                        and reclaimed_frac < base_frac / RECLAIM_BAND):
                    findings.append(SweepFinding(
                        "pipeline.headroom_reclaimed_frac",
                        f"reclaimed-headroom fraction collapsed: "
                        f"{reclaimed_frac:.3f} < baseline "
                        f"{base_frac:.3f} / {RECLAIM_BAND}"))
    tel = manifest.get("telescoping") or {}
    cov = tel.get("coverage")
    if not isinstance(cov, (int, float)) or isinstance(cov, bool) or \
            cov < TELESCOPE_MIN:
        findings.append(SweepFinding(
            "telescoping.coverage",
            f"bucket stage clocks cover {cov!r} of the sweep wall clock "
            f"(< {TELESCOPE_MIN}): the stage model no longer accounts "
            f"for where the time goes"))
    if timing_band is not None:
        wall = float(manifest.get("wall_s") or 0.0)
        base_wall = float(baseline.get("wall_s") or 0.0)
        if base_wall > 0 and wall > base_wall * timing_band:
            findings.append(SweepFinding(
                "wall_s",
                f"sweep wall {wall:.2f}s > {timing_band} x baseline "
                f"{base_wall:.2f}s"))
    return findings
