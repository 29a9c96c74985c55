#!/usr/bin/env python
"""Cliff-drift gate: atlas manifest vs the committed ATLAS_BASELINE.

Compares a phase-atlas manifest (``python -m benor_tpu_torch atlas``, or
bench.py's atlas blob) against a committed baseline with the drift
rules in ``benor_tpu_torch/atlas/gate.py`` — a known cliff that MOVES outside
its bracket band, VANISHES from its search, or whose committed minimal
repro STOPS REPRODUCING is a regression; extra discovery (new cliffs,
new searches, different probe budgets) is not.

Exit codes (the CI contract, same convention as
``check_sweep_regression.py`` and friends):

  0  in-band (or no committed baseline at the default path: use
     --strict to forbid that)
  2  at least one cliff-drift regression
  3  the documents are not comparable (different platform / device /
     capture scale / schema drift) or unreadable — the gate REFUSES
     rather than producing confident nonsense; recapture at the
     baseline scale or re-baseline

STDLIB-ONLY CONTRACT: this script gates a CI image, a laptop or the card's
host without torch or a device, so it loads the port's
``benor_tpu_torch/atlas/gate.py`` by FILE PATH — importing the
``benor_tpu_torch`` package would import torch (its __init__).
gate.py is stdlib-only by design; this loader keeps it honest (an
import creep there breaks this gate immediately).  The exit
contract, the arguments and the ``REGRESSION`` / ``note`` lines
are those of the JAX package's tools/check_atlas_regression.py, but
one: a BASELINE named on the command line that does not exist exits
3, as any document that cannot be read does (the JAX script passes it
with a note unless --strict).

Usage:
    python benor_tpu_torch/tools/check_atlas_regression.py MANIFEST [BASELINE]
        [--band X] [--strict]
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
GATE_MODULE = os.path.join(PKG, "atlas", "gate.py")
DEFAULT_BASELINE = os.path.join(REPO, "ATLAS_BASELINE.json")


def _load_gate():
    """atlas/gate.py as a standalone module (see STDLIB-ONLY CONTRACT in the
    module docstring)."""
    spec = importlib.util.spec_from_file_location("_atlas_gate",
                                                  GATE_MODULE)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves string annotations through
    # sys.modules[cls.__module__]; an unregistered module breaks it
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="atlas manifest vs baseline cliff-drift gate "
                    "(exit 0 in-band, 2 regression, 3 incomparable)")
    ap.add_argument("manifest", help="manifest to check (`python -m "
                                     "benor_tpu_torch atlas` output)")
    ap.add_argument("baseline", nargs="?", default=DEFAULT_BASELINE,
                    help="baseline manifest (default: the committed "
                         "ATLAS_BASELINE.json)")
    ap.add_argument("--band", type=float, default=None,
                    help="allowed point-estimate drift in units of the "
                         "baseline bracket width beyond each bracket "
                         "end (default: gate.CLIFF_BAND)")
    ap.add_argument("--strict", action="store_true",
                    help="a missing default baseline is exit 3 too, not a "
                         "pass (a missing named one always is)")
    args = ap.parse_args(argv)

    gate = _load_gate()
    if not os.path.exists(args.baseline):
        print(f"no baseline at {args.baseline} — nothing to gate "
              f"against (capture one via `python -m benor_tpu_torch atlas "
              f"--update-baseline`)", file=sys.stderr)
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
    if args.band is not None:
        kw["band"] = args.band
    try:
        findings = gate.compare_atlas(manifest, base, **kw)
    except gate.IncomparableAtlas as e:
        print(f"not comparable: {e}", file=sys.stderr)
        return 3
    for f in findings:
        print(f"REGRESSION: [{f.metric}] {f.message}")
    if findings:
        return 2
    print(f"{os.path.basename(args.manifest)}: in-band vs "
          f"{os.path.basename(args.baseline)} "
          f"({manifest.get('cliff_count')} cliffs, "
          f"{manifest.get('probe_count')} probes, "
          f"{manifest.get('compile_count')} compiles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
