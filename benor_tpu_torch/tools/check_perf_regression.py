#!/usr/bin/env python
"""Perf regression gate: manifest vs PERF_BASELINE.json + bench trend.

Compares a perfscope manifest (``python -m benor_tpu_torch profile
--profile-out``) against a committed baseline manifest with the
per-metric tolerance bands in ``benor_tpu_torch/perfscope/baseline.py`` —
STRUCTURAL metrics (FLOPs, bytes accessed, memory footprint,
deterministic round count) gate by default; machine-sensitive stage
timings only with ``--timing-band``.  Optionally walks the committed
``BENCH_r01..r*.json`` trajectory for same-platform throughput collapses
(``check_bench_trajectory``).

Exit codes (the CI contract, same 0/2 convention as
``benor_tpu_torch lint`` and ``benor_tpu_torch audit``):

  0  in-band (or no committed baseline at the default path: use
     --strict to forbid that)
  2  at least one regression / trajectory collapse
  3  the documents are not comparable (different platform / scale /
     schema) or unreadable — the gate REFUSES rather than producing
     confident nonsense; recapture at the baseline scale or re-baseline

STDLIB-ONLY CONTRACT: this script gates a CI image, a laptop or the card's
host without torch or a device, so it loads the port's
``benor_tpu_torch/perfscope/baseline.py`` by FILE PATH — importing the
``benor_tpu_torch`` package would import torch (its __init__).
baseline.py is stdlib-only by design; this loader keeps it honest (an
import creep there breaks this gate immediately).  The exit
contract, the arguments and the ``REGRESSION`` / ``note`` lines
are those of the JAX package's tools/check_perf_regression.py, but
one: a BASELINE named on the command line that does not exist exits
3, as any document that cannot be read does (the JAX script passes it
with a note unless --strict).

Usage:
    python benor_tpu_torch/tools/check_perf_regression.py MANIFEST [BASELINE]
        [--timing-band X] [--trajectory [GLOB]] [--strict]
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
BASELINE_MODULE = os.path.join(PKG, "perfscope", "baseline.py")
DEFAULT_BASELINE = os.path.join(REPO, "PERF_BASELINE.json")
DEFAULT_TRAJECTORY = os.path.join(REPO, "BENCH_r*.json")
MULTICHIP_TRAJECTORY = os.path.join(REPO, "MULTICHIP_r*.json")


def _load_baseline_module():
    """perfscope/baseline.py as a standalone module (see STDLIB-ONLY CONTRACT
    in the module docstring)."""
    spec = importlib.util.spec_from_file_location("_perfscope_baseline",
                                                  BASELINE_MODULE)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves string annotations through
    # sys.modules[cls.__module__]; an unregistered module breaks it
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="perfscope manifest vs baseline regression gate "
                    "(exit 0 in-band, 2 regression, 3 incomparable)")
    ap.add_argument("manifest", help="manifest to check (profile "
                                     "--profile-out output)")
    ap.add_argument("baseline", nargs="?", default=DEFAULT_BASELINE,
                    help="baseline manifest (default: the committed "
                         "PERF_BASELINE.json)")
    ap.add_argument("--timing-band", type=float, default=None,
                    help="also gate trace/compile/execute stage timings "
                         "at this new/old ratio band (off by default: "
                         "wall clocks are machine-sensitive)")
    ap.add_argument("--trajectory", nargs="?", const=DEFAULT_TRAJECTORY,
                    default=None, metavar="GLOB",
                    help="also walk the committed bench records for "
                         "same-platform throughput collapses (default "
                         "glob: BENCH_r*.json in the repo root) AND the "
                         "MULTICHIP_r*.json series for scaling-"
                         "efficiency collapses (missing/zero "
                         "scaling_efficiency on an ok record = the "
                         "worst collapse)")
    ap.add_argument("--strict", action="store_true",
                    help="a missing default baseline is exit 3 too, not a "
                         "pass (a missing named one always is)")
    args = ap.parse_args(argv)

    baseline_mod = _load_baseline_module()
    rc = 0

    try:
        manifest = _load_json(args.manifest)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable manifest: {e}", file=sys.stderr)
        return 3

    # the packed-loop pin — baseline-independent, it gates the manifest's
    # own fused_vs_xla block: the packed loop must beat the unfused one on
    # a real device; interpret-mode (CPU) captures gate the layout-derived
    # packed_traffic_ratio >= 4x instead (plain-version ratios excluded)
    fvx_findings = baseline_mod.check_fused_vs_xla(manifest)
    for f in fvx_findings:
        print(f)
    if any(f.startswith("REGRESSION") for f in fvx_findings):
        rc = 2

    if not os.path.exists(args.baseline):
        print(f"no baseline at {args.baseline} — nothing to gate against"
              f" (run `python -m benor_tpu_torch profile --update-baseline "
              f"--baseline PATH`)", file=sys.stderr)
        if args.strict or args.baseline != DEFAULT_BASELINE:
            # a regression the fused_vs_xla gate already detected must
            # not be downgraded to "incomparable" by the missing baseline
            return rc or 3
    else:
        try:
            base = _load_json(args.baseline)
        except (OSError, json.JSONDecodeError) as e:
            print(f"unreadable input: {e}", file=sys.stderr)
            return 3
        try:
            regressions = baseline_mod.compare_manifests(
                manifest, base, timing_band=args.timing_band)
        except baseline_mod.IncomparableManifests as e:
            print(f"not comparable: {e}", file=sys.stderr)
            return 3
        for reg in regressions:
            print(f"REGRESSION: {reg.message}")
        if regressions:
            rc = 2
        else:
            print(f"{os.path.basename(args.manifest)}: in-band vs "
                  f"{os.path.basename(args.baseline)} "
                  f"({len(manifest.get('regimes', {}))} regimes, "
                  f"{len(baseline_mod.STRUCTURAL_BANDS)} banded metrics"
                  + (f", timing band {args.timing_band}x"
                     if args.timing_band else "") + ")")

    if args.trajectory:
        paths = sorted(glob.glob(args.trajectory))
        findings = baseline_mod.check_bench_trajectory(paths)
        for f in findings:
            print(f)
        if any(f.startswith("REGRESSION") for f in findings):
            rc = max(rc, 2)
        else:
            print(f"trajectory: no same-platform collapse across "
                  f"{len(paths)} records")
        # pallas kernel-ratio walk: interpret-mode records (CPU pallas
        # emulation) are labeled and EXCLUDED — their ratios price the
        # interpreter, not the kernels (baseline.py explains)
        pfindings = baseline_mod.check_pallas_speedup_trajectory(paths)
        for f in pfindings:
            print(f)
        if any(f.startswith("REGRESSION") for f in pfindings):
            rc = max(rc, 2)
        else:
            print("pallas trajectory: no real-backend kernel-ratio "
                  "collapse (interpret-mode records excluded)")
        # the multichip capture series rides the same flag: a missing or
        # zero scaling_efficiency on an ok record is the WORST collapse
        # (mirroring the node_rounds_per_sec=0.0 rule; see
        # baseline.check_multichip_trajectory)
        mpaths = sorted(glob.glob(MULTICHIP_TRAJECTORY))
        mfindings = baseline_mod.check_multichip_trajectory(mpaths)
        for f in mfindings:
            print(f)
        if any(f.startswith("REGRESSION") for f in mfindings):
            rc = max(rc, 2)
        else:
            print(f"multichip trajectory: no scaling-efficiency "
                  f"collapse across {len(mpaths)} records")

    return rc


if __name__ == "__main__":
    sys.exit(main())
