#!/usr/bin/env python
"""Serve regression gate: load manifest vs the committed SERVE_BASELINE.

Compares a serve manifest (``python -m benor_tpu_torch load --profile-out``)
against a committed baseline with the coalescing / completion / error
rules in ``benor_tpu_torch/serve/gate.py`` — jobs-per-launch (the coalescing
efficiency serving exists to produce) gates at a ratio band with
"collapsed to per-job dispatch" as the worst finding, any client error
or leaked batch slot is a regression on its own, servescope's
attribution cross-check (stage means must telescope to the client mean
latency) gates unconditionally, the queue-wait and launch stage p99s
band against baseline at ``gate.STAGE_P99_BANDS`` over an absolute
noise floor (``--stage-band`` overrides the ratio), and the remaining
machine-sensitive wall-clock metrics (end-to-end p50/p99 latency,
throughput) are carried for trend reading but only gate under an
explicit ``--timing-band``.

Exit codes (the CI contract, same convention as
``check_perf_regression.py`` / ``check_scaling_regression.py``):

  0  in-band (or no committed baseline at the default path: use
     --strict to forbid that)
  2  at least one serving regression
  3  the documents are not comparable (different platform / job scale /
     fewer clients than baseline / schema drift) or unreadable — the
     gate REFUSES rather than producing confident nonsense; recapture
     at the baseline scale or re-baseline

STDLIB-ONLY CONTRACT: this script gates a CI image, a laptop or the card's
host without torch or a device, so it loads the port's
``benor_tpu_torch/serve/gate.py`` by FILE PATH — importing the
``benor_tpu_torch`` package would import torch (its __init__).
gate.py is stdlib-only by design; this loader keeps it honest (an
import creep there breaks this gate immediately).  The exit
contract, the arguments and the ``REGRESSION`` / ``note`` lines
are those of the JAX package's tools/check_serve_regression.py, but
one: a BASELINE named on the command line that does not exist exits
3, as any document that cannot be read does (the JAX script passes it
with a note unless --strict).

Usage:
    python benor_tpu_torch/tools/check_serve_regression.py MANIFEST [BASELINE]
        [--coalescing-band X] [--stage-band X] [--timing-band X]
        [--strict]
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
GATE_MODULE = os.path.join(PKG, "serve", "gate.py")
DEFAULT_BASELINE = os.path.join(REPO, "SERVE_BASELINE.json")


def _load_gate():
    """serve/gate.py as a standalone module (see STDLIB-ONLY CONTRACT in the
    module docstring)."""
    spec = importlib.util.spec_from_file_location("_serve_gate",
                                                  GATE_MODULE)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves string annotations through
    # sys.modules[cls.__module__]; an unregistered module breaks it
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve manifest vs baseline regression gate "
                    "(exit 0 in-band, 2 regression, 3 incomparable)")
    ap.add_argument("manifest", help="manifest to check (load "
                                     "--profile-out output)")
    ap.add_argument("baseline", nargs="?", default=DEFAULT_BASELINE,
                    help="baseline manifest (default: the committed "
                         "SERVE_BASELINE.json)")
    ap.add_argument("--coalescing-band", type=float, default=None,
                    help="floor on new/baseline jobs-per-launch ratio "
                         "(default: gate.COALESCING_BAND)")
    ap.add_argument("--stage-band", type=float, default=None,
                    help="override the default stage-p99 ratio band "
                         "for the default-gated stages (queue_wait, "
                         "launch; default: gate.STAGE_P99_BANDS)")
    ap.add_argument("--timing-band", type=float, default=None,
                    help="also gate throughput and p99 latency at this "
                         "ratio band (off by default: shared CI "
                         "machines make wall clocks noisy)")
    ap.add_argument("--strict", action="store_true",
                    help="a missing default baseline is exit 3 too, not a "
                         "pass (a missing named one always is)")
    args = ap.parse_args(argv)

    gate = _load_gate()
    if not os.path.exists(args.baseline):
        print(f"no baseline at {args.baseline} — nothing to gate "
              f"against (run `python -m benor_tpu_torch load "
              f"--update-baseline --baseline PATH`)", file=sys.stderr)
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
    if args.coalescing_band is not None:
        kw["coalescing_band"] = args.coalescing_band
    if args.timing_band is not None:
        kw["timing_band"] = args.timing_band
    if args.stage_band is not None:
        kw["stage_bands"] = {s: args.stage_band
                             for s in gate.STAGE_P99_BANDS}
    try:
        findings = gate.compare_serve(manifest, base, **kw)
    except gate.IncomparableServe as e:
        print(f"not comparable: {e}", file=sys.stderr)
        return 3
    for f in findings:
        print(f"REGRESSION: {f.message}")
    if findings:
        return 2
    print(f"{os.path.basename(args.manifest)}: in-band vs "
          f"{os.path.basename(args.baseline)} "
          f"({manifest.get('clients')} clients, "
          f"{manifest.get('jobs_per_launch')} jobs/launch)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
