#!/usr/bin/env python3
"""Times and resources of the round kernels, the histogram counts kernels
and the coin kernels of two checkouts, on one GPU.

    python3 round_stats.py                 # this checkout
    python3 round_stats.py --base DIR      # and the checkout at DIR, in turns

Each checkout is timed in a process of its own (with ``--base``: base,
this, this, base), with that checkout's package first on ``sys.path``.
There it runs chip_smoke.py's random N = 1,000,000 x 32 fixture through
chip_smoke.py's ``round_pair`` (``proposal_hist`` and ``vote_commit``
against their plain versions, then three repeats of the mean over 20
launches) and its balanced counts fixture through ``hist_pair``
(``cf_counts`` and ``equiv_counts`` the same way) and the coins through
``coin_pair`` (``coin_flips`` and ``weak_coin_flips`` at N = 1M x 32, the
weak coin checked at each of ``COIN_EPS`` and timed at eps = 0.5), times
``dense_counts`` (T = 32, R = S = 2048) as a control and reads
``clocks.sm`` while ``vote_commit``, ``cf_counts`` and ``coin_flips`` run.
Then it prints each checkout's registers, spills, shared memory, SASS mix
and pipe floors of the three kernel sets (benor_tpu_torch/ops/sass.py).
Prints one JSON line last and writes the whole result to
chiprun_out/round_stats.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# this checkout's chip_smoke.py, imported before a worker puts another
# checkout (which holds its own chip_smoke.py) first on sys.path
import chip_smoke as cs

ROOT = Path(__file__).resolve().parent


def worker(tree: Path) -> dict:
    """Time one checkout's round kernels -> a result dict.  ``tree`` is put
    first on sys.path, so its package is the one timed; the fixture, the
    check and the timing are this checkout's chip_smoke.py."""
    sys.path.insert(0, str(tree))
    import torch

    import benor_tpu_torch
    from benor_tpu_torch.ops import _build
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk

    if not Path(benor_tpu_torch.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise SystemExit(f"imported {benor_tpu_torch.__file__}, not {tree}")

    lib = _build.load_library()
    dev = torch.device("cuda")
    cfg = cs.main_cfg()
    pack, hist1 = cs.random_pack(cfg, dev, cs.SEED)
    rnd = cs.round_pair("random", lib, cfg, pack, hist1)
    counts = cs.hist_pair("balanced", lib, cs.cf_fixtures(dev)["balanced"],
                          cs.equiv_fixtures(dev)["balanced"])
    coins = cs.coin_pair("balanced", lib, cs.TRIALS, cs.N_MAIN, dev)
    dense = cs.dense_case(cs.TRIALS, cs.N_DENSE, cs.N_DENSE, dev)
    ms = dict(rnd["ms"], **counts["ms"], **coins["ms"],
              dense_counts=cs.repeats(
                  lambda: dk._launch_dense_counts(lib, *dense)))
    return dict(tree=str(tree), lanes=rnd["lanes"],
                hist_lanes=cs.TRIALS * cs.N_MAIN, ms=ms,
                clocks_sm_mhz=cs.clock_during(rnd["calls"]["vote_commit"]),
                hist_clocks_sm_mhz=cs.clock_during(
                    counts["calls"]["cf_counts"]),
                coin_clocks_sm_mhz=cs.clock_during(
                    coins["calls"]["coin_flips"]),
                coin_nodes=getattr(hk, "COIN_NODES", 1),
                sms=torch.cuda.get_device_properties(0).multi_processor_count)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("round_stats: no CUDA device available", file=sys.stderr)
        return 1
    if "--worker" in sys.argv:
        tree = Path(sys.argv[sys.argv.index("--worker") + 1])
        print(json.dumps(worker(tree)))
        return 0
    from benor_tpu_torch.ops import _build, sass

    trees = [("this", ROOT)]
    if "--base" in sys.argv:
        base = Path(sys.argv[sys.argv.index("--base") + 1]).resolve()
        trees = [("base", base), ("this", ROOT), ("this", ROOT),
                 ("base", base)]
    card = cs.smi("name,power.limit")
    results = []
    for tag, tree in trees:
        out = subprocess.run([sys.executable, str(ROOT / "round_stats.py"),
                              "--worker", str(tree)], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["tag"] = tag
        results.append(res)
        print(f"[time] {tag} ({tree}): " + "; ".join(
            f"{k} {v} ms" for k, v in res["ms"].items())
            + f"; clocks.sm {res['clocks_sm_mhz']:.0f} MHz (vote_commit), "
            f"{res['hist_clocks_sm_mhz']:.0f} MHz (cf_counts), "
            f"{res['coin_clocks_sm_mhz']:.0f} MHz (coin_flips); kernels == "
            "plain")
    reports = {}
    for res in results:
        tree = Path(res["tree"])
        if res["tag"] in reports:
            continue
        csrc = tree / "benor_tpu_torch" / "csrc"
        rep = reports[res["tag"]] = {
            "round": sass.resource_report(csrc / "round_kernels.cu",
                                          _build.BUILD_DIR),
            "hist": sass.resource_report(csrc / "hist_kernels.cu",
                                         _build.BUILD_DIR, sass.HIST_KERNELS),
            "coins": sass.resource_report(csrc / "hist_kernels.cu",
                                          _build.BUILD_DIR,
                                          sass.COIN_KERNELS)}
        sass.print_resources(res["tag"], rep["round"], res["lanes"],
                             res["sms"], res["clocks_sm_mhz"])
        sass.print_resources(res["tag"], rep["hist"], res["hist_lanes"],
                             res["sms"], res["hist_clocks_sm_mhz"])
        sass.print_resources(res["tag"], rep["coins"], res["hist_lanes"],
                             res["sms"], res["coin_clocks_sm_mhz"],
                             res["coin_nodes"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "round_stats.json").write_text(json.dumps(
        {"card": card, "runs": results, "resources": reports}, indent=1))
    print(card)
    print(json.dumps({"card": card, "runs": [
        {k: res[k] for k in ("tag", "ms", "clocks_sm_mhz",
                             "hist_clocks_sm_mhz", "coin_clocks_sm_mhz")}
        for res in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
