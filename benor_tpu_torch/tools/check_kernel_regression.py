#!/usr/bin/env python
"""Kernel regression gate: kernel manifest vs the committed baseline.

Compares a kernel manifest (``python -m benor_tpu_torch profile --kernels``,
or bench.py's kernelscope blob) against a committed baseline with the
band rules in ``benor_tpu_torch/kernelscope/gate.py``:

  * stage counters must match EXACTLY at the baseline scale/seed —
    they are deterministic integers measured inside the kernels, so
    any drift means the kernel interior changed work without an
    acknowledged re-baseline;
  * the pad-waste fraction (active vs padded lanes, the re-tiling
    target number) may not grow past the slack;
  * the layout-predicted/cost-model-measured byte ratio must stay in
    band both directions — the telescoping check that turns "fused
    loses" into "fused loses because stage X moves Y bytes";
  * a kernel dispatch the baseline measured may not silently vanish,
    and a fused-vs-XLA pair must stay bit-equal.

Exit codes (the CI contract, same convention as
``check_perf_regression.py`` and its siblings):

  0  in-band (or no committed baseline at the default path: use
     --strict to forbid that)
  2  at least one kernel-plane regression
  3  the documents are not comparable (different platform / interpret
     mode / capture scale) or unreadable — the gate REFUSES rather
     than producing confident nonsense; recapture at the baseline
     scale or re-baseline

STDLIB-ONLY CONTRACT: this script gates a CI image, a laptop or the card's
host without torch or a device, so it loads the port's
``benor_tpu_torch/kernelscope/gate.py`` by FILE PATH — importing the
``benor_tpu_torch`` package would import torch (its __init__).
gate.py is stdlib-only by design; this loader keeps it honest (an
import creep there breaks this gate immediately).  The exit
contract, the arguments and the ``REGRESSION`` / ``note`` lines
are those of the JAX package's tools/check_kernel_regression.py, but
one: a BASELINE named on the command line that does not exist exits
3, as any document that cannot be read does (the JAX script passes it
with a note unless --strict).

Usage:
    python benor_tpu_torch/tools/check_kernel_regression.py MANIFEST [BASELINE]
        [--ratio-band X] [--strict]
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
GATE_MODULE = os.path.join(PKG, "kernelscope", "gate.py")
DEFAULT_BASELINE = os.path.join(REPO, "KERNEL_BASELINE.json")


def _load_gate():
    """kernelscope/gate.py as a standalone module (see STDLIB-ONLY CONTRACT
    in the module docstring)."""
    spec = importlib.util.spec_from_file_location("_kernel_gate",
                                                  GATE_MODULE)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves string annotations through
    # sys.modules[cls.__module__]; an unregistered module breaks it
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _load_doc(path: str, what: str):
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"INCOMPARABLE: cannot read {what} {path}: {e}",
              file=sys.stderr)
        return None
    if doc.get("kind") != "kernel_manifest":
        print(f"INCOMPARABLE: {what} {path} is kind="
              f"{doc.get('kind')!r}, not a kernel manifest",
              file=sys.stderr)
        return None
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="kernel manifest vs baseline regression gate "
                    "(exit 0 in-band, 2 regression, 3 incomparable)")
    ap.add_argument("manifest", help="manifest to check (profile "
                                     "--kernels output)")
    ap.add_argument("baseline", nargs="?", default=DEFAULT_BASELINE,
                    help="baseline manifest (default: the committed "
                         "KERNEL_BASELINE.json)")
    ap.add_argument("--ratio-band", type=float, default=None,
                    help="multiplicative band on the predicted/"
                         "measured byte ratio vs baseline (default: "
                         "gate.BYTE_RATIO_BAND)")
    ap.add_argument("--strict", action="store_true",
                    help="a missing default baseline is an error too "
                         "instead of a pass-with-note (a missing named "
                         "one always is)")
    args = ap.parse_args(argv)

    gate = _load_gate()
    manifest = _load_doc(args.manifest, "manifest")
    if manifest is None:
        return 3
    if not os.path.exists(args.baseline):
        msg = (f"no baseline at {args.baseline} — nothing to gate "
               f"against")
        if args.strict or args.baseline != DEFAULT_BASELINE:
            print(f"INCOMPARABLE: {msg} "
                  f"({'--strict' if args.strict else 'named baseline'})",
                  file=sys.stderr)
            return 3
        print(f"note: {msg}", file=sys.stderr)
        return 0
    baseline = _load_doc(args.baseline, "baseline")
    if baseline is None:
        return 3

    kw = {}
    if args.ratio_band is not None:
        kw["ratio_band"] = args.ratio_band
    try:
        findings = gate.compare_kernels(manifest, baseline, **kw)
    except gate.IncomparableKernels as e:
        print(f"INCOMPARABLE: {e}", file=sys.stderr)
        return 3
    for f in findings:
        print(f"REGRESSION [{f.kind}]: {f.message}", file=sys.stderr)
    if findings:
        return 2
    print(f"kernel gate: in-band vs {args.baseline}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
