#!/usr/bin/env python
"""Sweep regression gate: sweep manifest vs the committed SWEEP_BASELINE.

Compares a sweep manifest (``python -m benor_tpu_torch sweep --batched
--manifest-out``, or bench.py's sweepscope blob) against a committed
baseline with the pipeline/bucketing rules in
``benor_tpu_torch/sweepscope/gate.py`` — the overlap-headroom fraction (the
wall-clock an ideal compile-ahead/execute-behind pipeline would reclaim,
as a share of the serial wall) gates at a ratio band with a vanished
headroom as the worst finding, a compile-count increase at the same
scale gates as a bucketing collapse, the per-bucket stage clocks must
keep telescoping to the sweep wall, and the machine-sensitive wall
clock itself only gates under an explicit ``--timing-band``.

Exit codes (the CI contract, same convention as
``check_perf_regression.py`` / ``check_scaling_regression.py`` /
``check_serve_regression.py``):

  0  in-band (or no committed baseline at the default path: use
     --strict to forbid that)
  2  at least one sweep-plane regression
  3  the documents are not comparable (different platform / sweep
     scale / schema drift) or unreadable — the gate REFUSES rather
     than producing confident nonsense; recapture at the baseline
     scale or re-baseline

STDLIB-ONLY CONTRACT: this script gates a CI image, a laptop or the card's
host without torch or a device, so it loads the port's
``benor_tpu_torch/sweepscope/gate.py`` by FILE PATH — importing the
``benor_tpu_torch`` package would import torch (its __init__).
gate.py is stdlib-only by design; this loader keeps it honest (an
import creep there breaks this gate immediately).  The exit
contract, the arguments and the ``REGRESSION`` / ``note`` lines
are those of the JAX package's tools/check_sweep_regression.py, but
one: a BASELINE named on the command line that does not exist exits
3, as any document that cannot be read does (the JAX script passes it
with a note unless --strict).

Usage:
    python benor_tpu_torch/tools/check_sweep_regression.py MANIFEST [BASELINE]
        [--headroom-band X] [--timing-band X] [--strict]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
GATE_MODULE = os.path.join(PKG, "sweepscope", "gate.py")
DEFAULT_BASELINE = os.path.join(REPO, "SWEEP_BASELINE.json")


def _load_gate():
    """sweepscope/gate.py as a standalone module (see STDLIB-ONLY CONTRACT
    in the module docstring)."""
    spec = importlib.util.spec_from_file_location("_sweep_gate",
                                                  GATE_MODULE)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves string annotations through
    # sys.modules[cls.__module__]; an unregistered module breaks it
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep manifest vs baseline regression gate "
                    "(exit 0 in-band, 2 regression, 3 incomparable)")
    ap.add_argument("manifest", help="manifest to check (sweep "
                                     "--manifest-out output)")
    ap.add_argument("baseline", nargs="?", default=DEFAULT_BASELINE,
                    help="baseline manifest (default: the committed "
                         "SWEEP_BASELINE.json)")
    ap.add_argument("--headroom-band", type=float, default=None,
                    help="ratio band on the overlap-headroom fraction "
                         "vs baseline before it counts as a "
                         "serialization regression (default: "
                         "gate.HEADROOM_BAND)")
    ap.add_argument("--timing-band", type=float, default=None,
                    help="also gate the end-to-end sweep wall clock at "
                         "this ratio band (off by default: shared CI "
                         "machines make wall clocks noisy)")
    ap.add_argument("--strict", action="store_true",
                    help="a missing default baseline is exit 3 too, not a "
                         "pass (a missing named one always is)")
    args = ap.parse_args(argv)

    gate = _load_gate()
    if not os.path.exists(args.baseline):
        print(f"no baseline at {args.baseline} — nothing to gate "
              f"against (capture one via benor_tpu_torch.sweepscope."
              f"capture_sweep_manifest)", file=sys.stderr)
        return 3 if args.strict or args.baseline != DEFAULT_BASELINE \
            else 0
    try:
        with open(args.manifest) as fh:
            manifest = json.load(fh)
        with open(args.baseline) as fh:
            base = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable input: {e}", file=sys.stderr)
        return 3
    kw = {}
    if args.headroom_band is not None:
        kw["headroom_band"] = args.headroom_band
    if args.timing_band is not None:
        kw["timing_band"] = args.timing_band
    try:
        findings = gate.compare_sweep(manifest, base, **kw)
    except gate.IncomparableSweep as e:
        print(f"not comparable: {e}", file=sys.stderr)
        return 3
    for f in findings:
        print(f"REGRESSION: {f.message}")
    if findings:
        return 2
    print(f"{os.path.basename(args.manifest)}: in-band vs "
          f"{os.path.basename(args.baseline)} "
          f"({manifest.get('n_buckets')} buckets, "
          f"{manifest.get('compile_count')} compiles, headroom "
          f"{manifest.get('overlap_headroom_frac')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
