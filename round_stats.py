#!/usr/bin/env python3
"""Times and resources of the round kernels, the histogram counts kernels
and the coin kernels of two checkouts, on one GPU.

    python3 round_stats.py                 # this checkout
    python3 round_stats.py --base DIR      # and the checkout at DIR, in turns
    python3 round_stats.py --fused-scan [DIR ...]   # the fused kernel's grids
    python3 round_stats.py --sass-diff DIR          # the round kernels' SASS

Each checkout is timed in a process of its own (with ``--base``: base,
this, this, base), with that checkout's package first on ``sys.path``,
after a fresh build of each checkout's kernels is timed (``build_time``).
There it runs chip_smoke.py's random N = 1,000,000 x 32 fixture through
chip_smoke.py's ``round_pair`` (``proposal_hist`` and ``vote_commit``
against their plain versions, then three repeats of the mean over 20
launches) and its balanced counts fixture through ``hist_pair``
(``cf_counts`` and ``equiv_counts`` the same way) and the coins through
``coin_pair`` (``coin_flips`` and ``weak_coin_flips`` at N = 1M x 32, the
weak coin checked at each of ``COIN_EPS`` and timed at eps = 0.5) and the
fused round at each shape of ``FUSED_FAMILY`` through ``fused_family``
(against its plain version and the two-kernel route, then the kernel, the
fused wrapper and the route timed as every kernel is and queued: the
card asleep ~10 ms first, so that the device's time alone is read), times ``dense_counts`` (T = 32,
R = S = 2048) as a control and reads ``clocks.sm`` while ``vote_commit``,
``cf_counts``, ``coin_flips`` and ``fused_round`` run.  Then it prints each
checkout's registers, spills, shared memory, SASS mix and pipe floors of
the kernel sets (benor_tpu_torch/ops/sass.py; every mode instantiation of
the round kernels, where the checkout has them): the fused round's for the
lanes of its N = 8192 x 32 shape, with the N = 10 x 1 kernel time (one
word a warp: the latency probe) beside them.  Last, end to end, it times
``run_consensus`` on the packed path's runs that take the fused kernel
(N = 8192 at 32 trials and at one; ``fused_split``).
Prints one JSON line last and writes the whole result to
chiprun_out/round_stats.json.

``--sass-diff DIR`` compares instead, instruction by instruction, the SASS
of every round kernel instantiation that csrc/round_kernels.cu and
csrc/round_b2.cu build in the checkout at DIR with this checkout's (every
hexadecimal constant masked, so that moved addresses do not count), and
prints the number identical and differing, the first differences, and
the instantiations only one checkout has.

``--fused-scan DIR ...`` times instead the fused kernel of each checkout
(this one if none is named; in turns, each in a process of its own) on
every grid (C blocks of W warps a trial) it takes at each shape of
``FUSED_FAMILY`` (queued: the device's time), each grid checked against
the plain version first, and marks the grid its rule picks; the whole result is the last line, as
JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# this checkout's chip_smoke.py, imported before a worker puts another
# checkout (which holds its own chip_smoke.py) first on sys.path
import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SPLIT_REPS = 5     # timed run_consensus runs of each fused-path case


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
    family = cs.fused_family(lib, dev)
    cap = family[cs.FUSED_FAMILY[0]]
    split = fused_split(dev)
    ms = dict(rnd["ms"], **counts["ms"], **coins["ms"],
              fused_round=cap["ms"]["kernel"],
              fused_round_queued=cap["ms"]["kernel_queued"],
              dense_counts=cs.repeats(
                  lambda: dk._launch_dense_counts(lib, *dense)))
    return dict(tree=str(tree), lanes=rnd["lanes"],
                hist_lanes=cs.TRIALS * cs.N_MAIN, ms=ms,
                fused_lanes=cap["lanes"],
                fused_family={f"{t}x{n}": f["ms"]
                              for (t, n), f in family.items()},
                fused_clocks_sm_mhz=cs.clock_during(cap["kernel"]),
                fused_split=split,
                clocks_sm_mhz=cs.clock_during(rnd["calls"]["vote_commit"]),
                hist_clocks_sm_mhz=cs.clock_during(
                    counts["calls"]["cf_counts"]),
                coin_clocks_sm_mhz=cs.clock_during(
                    coins["calls"]["coin_flips"]),
                coin_nodes=getattr(hk, "COIN_NODES", 1),
                sms=torch.cuda.get_device_properties(0).multi_processor_count)


def build_time(tree: Path) -> float:
    """Wall seconds of a fresh build of ``tree``'s kernel library (every
    source's nvcc side by side, then the link) into a new directory, in a
    process of its own, the package import left out."""
    out_dir = ROOT / "build" / "benor_tpu_torch" / f"timed.{time.time_ns()}"
    code = ("import sys, time; from pathlib import Path; "
            f"sys.path.insert(0, {str(tree)!r}); "
            "from benor_tpu_torch.ops import _build; "
            "t0 = time.perf_counter(); "
            f"_build.compile_library(_build.FLAGS, Path({str(out_dir)!r})); "
            "print(time.perf_counter() - t0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return float(out.stdout.strip().splitlines()[-1])


def fused_split(dev, reps: int = SPLIT_REPS) -> dict:
    """``run_consensus`` wall seconds of the packed path's runs that take
    the fused kernel (``chip_smoke.fused_run_cases``: N = 8192 at 32 trials
    and at one), as chip_smoke's [split] times them: after one warm-up
    run, ``reps`` runs, each on a state built first -> {name: [s]}."""
    import torch
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import init_state

    out = {}
    for name, c, vals, fl in cs.fused_run_cases(cs.MAIN_RUN, dev):
        secs = []
        for _ in range(reps + 1):
            st = init_state(c, vals, fl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_consensus(c, st, fl)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = secs[1:]
    return out


def fused_scan(tree: Path) -> dict:
    """Time one checkout's fused kernel on every grid (C, W) it takes at
    each shape of FUSED_FAMILY, each grid's outputs checked equal to the
    plain version's first -> {"T x N": {"C x W": [ms repeats]}}, with the
    rule's choice under "chosen" and the card's clusters at once by grid
    under "fits"."""
    sys.path.insert(0, str(tree))
    import torch

    from benor_tpu_torch.ops import _build, rng
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal

    lib = _build.load_library()
    dev = torch.device("cuda")
    fits = pr.fused_fits(lib, dev)
    out = {"fits": {f"{c}x{w}": n for (c, w), n in fits.items()}}
    keys = [stream_scal(cs.SEED, cs.ROUND, s) for s in (
        rng.PHASE_PROPOSAL, rng.PHASE_VOTE, _COIN_SALT)]
    for t, n in cs.FUSED_FAMILY:
        cfg = cs.main_cfg().replace(n_nodes=n, n_faulty=n // 4, trials=t)
        pack, hist = cs.random_pack(cfg, dev, cs.SEED + 1)
        n_w = pack.shape[2]
        want = pr.fused_round_plain(cs.SEED, cs.ROUND, hist, pack,
                                    cfg.quorum, cfg.n_faulty, "reference",
                                    **cs.MODES)
        args = (lib, *keys, cs.ROUND + 1, count_vecs(hist), pack,
                cfg.quorum, cfg.n_faulty, "reference", "crash", True)
        shape = out[f"{t}x{n}"] = {
            "chosen": "x".join(map(str, pr.fused_grid(lib, n_w, t, dev)))}
        for c in pr.FUSED_CLUSTERS:
            for w in pr.FUSED_WARPS:
                if not c * w <= n_w <= c * w * pr.FUSED_KEEP:
                    continue
                got = pr._launch_fused_round(*args, grid=(c, w))
                cs.compare(f"fused_round T={t} N={n} C={c} W={w}",
                           t * n_w * 32, list(zip(got, want)))
                shape[f"{c}x{w}"] = cs.repeats(
                    lambda: pr._launch_fused_round(*args, grid=(c, w)),
                    queued=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("round_stats: no CUDA device available", file=sys.stderr)
        return 1
    if "--worker" in sys.argv:
        tree = Path(sys.argv[sys.argv.index("--worker") + 1])
        print(json.dumps(worker(tree)))
        return 0
    if "--scan-worker" in sys.argv:
        tree = Path(sys.argv[sys.argv.index("--scan-worker") + 1])
        print(json.dumps(fused_scan(tree)))
        return 0
    if "--fused-scan" in sys.argv:
        return scan_main([Path(a).resolve() for a in
                          sys.argv[sys.argv.index("--fused-scan") + 1:]]
                         or [ROOT])
    if "--sass-diff" in sys.argv:
        return sass_diff(Path(sys.argv[sys.argv.index("--sass-diff") + 1])
                         .resolve())
    from benor_tpu_torch.ops import _build, sass

    trees = [("this", ROOT)]
    if "--base" in sys.argv:
        base = Path(sys.argv[sys.argv.index("--base") + 1]).resolve()
        trees = [("base", base), ("this", ROOT), ("this", ROOT),
                 ("base", base)]
    card = cs.smi("name,power.limit")
    builds = {tag: build_time(tree) for tag, tree in dict(trees).items()}
    print("[build] a fresh build, s: " + ", ".join(
        f"{tag} {sec:.1f}" for tag, sec in builds.items()))
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
            f"{res['coin_clocks_sm_mhz']:.0f} MHz (coin_flips), "
            f"{res['fused_clocks_sm_mhz']:.0f} MHz (fused_round); kernels "
            "== plain")
        for sfx in ("", "_queued"):
            print(f"[time] {tag} fused_round family{sfx} (T x N: kernel; "
                  "fused wrapper; two-kernel route, ms): " + "; ".join(
                      f"{shape}: {v['kernel' + sfx]}; {v['fused' + sfx]}; "
                      f"{v['two_kernel' + sfx]}"
                      for shape, v in res["fused_family"].items()))
        print(f"[split] {tag} run_consensus (s): " + "; ".join(
            f"{name} {v} (median {cs.median(v):.6f})"
            for name, v in res["fused_split"].items()))
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
        fused = {k: v for k, v in rep["round"].items()
                 if k.split("<")[0] in sass.FUSED_KERNELS}
        sass.print_resources(res["tag"], {
            k: v for k, v in rep["round"].items() if k not in fused},
            res["lanes"], res["sms"], res["clocks_sm_mhz"])
        sass.print_resources(
            res["tag"], fused, res["fused_lanes"], res["sms"],
            res["fused_clocks_sm_mhz"],
            latency_ms=cs.median(
                res["fused_family"]["1x10"]["kernel_queued"]))
        sass.print_resources(res["tag"], rep["hist"], res["hist_lanes"],
                             res["sms"], res["hist_clocks_sm_mhz"])
        sass.print_resources(res["tag"], rep["coins"], res["hist_lanes"],
                             res["sms"], res["coin_clocks_sm_mhz"],
                             res["coin_nodes"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "round_stats.json").write_text(json.dumps(
        {"card": card, "builds": builds, "runs": results,
         "resources": reports}, indent=1))
    print(card)
    print(json.dumps({"card": card, "runs": [
        {k: res[k] for k in ("tag", "ms", "clocks_sm_mhz",
                             "hist_clocks_sm_mhz", "coin_clocks_sm_mhz",
                             "fused_clocks_sm_mhz", "fused_family",
                             "fused_split")}
        for res in results]}))
    return 0


def sass_diff(base: Path) -> int:
    """``--sass-diff DIR``: the round kernels' SASS of the checkout at
    ``base`` against this one's, source by source (see the module
    docstring)."""
    import difflib

    from benor_tpu_torch.ops import _build, sass

    same = differ = only = 0
    for src in ("round_kernels.cu", "round_b2.cu"):
        a, b = (sass.listings(tree / "benor_tpu_torch" / "csrc" / src,
                              _build.BUILD_DIR)
                for tree in (base, ROOT))
        for label in sorted(set(a) & set(b)):
            if a[label] == b[label]:
                same += 1
                continue
            differ += 1
            lines = list(difflib.unified_diff(a[label], b[label],
                                              lineterm="", n=1))
            print(f"[sass-diff] {src} {label}: base {len(a[label])} this "
                  f"{len(b[label])} instructions; " + " | ".join(lines[:24]))
        only += len(set(a) ^ set(b))
        print(f"[sass-diff] {src}: only in the base "
              f"{sorted(set(a) - set(b))}, only in this checkout "
              f"{sorted(set(b) - set(a))}")
    print(f"[sass-diff] {base} against this checkout: {same} identical, "
          f"{differ} differing, {only} in one checkout only")
    return 1 if differ or only else 0


def scan_main(trees: list[Path]) -> int:
    """``--fused-scan DIR ...``: fused_scan of each checkout in turn, each
    in a process of its own; one line a shape and checkout, the times of
    every grid (median of the repeats), the rule's choice marked *; then
    the card and every repeat as one JSON line."""
    card = cs.smi("name,power.limit")
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, str(ROOT / "round_stats.py"),
                              "--scan-worker", str(tree)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(tree), **res})
        print(f"[scan] {tree}: clusters at once by C x W {res['fits']}")
        for shape, grids in res.items():
            if shape == "fits":
                continue
            print(f"[scan] {tree} T x N = {shape}: " + ", ".join(
                f"{g}{'*' if g == grids['chosen'] else ''} "
                f"{cs.median(v):.4f}" for g, v in grids.items()
                if g != "chosen") + " ms")
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
