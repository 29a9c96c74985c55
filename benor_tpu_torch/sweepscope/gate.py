"""The bucket-stage model of the sweep engine (port of
benor_tpu/sweepscope/gate.py:100-166): the strictly serial wall of a run's
measured stage clocks, the wall of the ideal compile-ahead / execute-behind
pipeline over them, and the headroom between the two.  A bucket's stages
are ``prepare_s`` and ``compile_s`` (host work), ``run_s`` (device work)
and ``fetch_s`` (host work a pipeline drains off the critical path)."""

from __future__ import annotations

from typing import List

STAGES = ("prepare_s", "compile_s", "run_s", "fetch_s")


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
