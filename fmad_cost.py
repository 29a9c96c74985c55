#!/usr/bin/env python3
"""What ``-fmad=false`` costs the round kernels, on one GPU.

    python3 fmad_cost.py

Builds the kernel library twice from benor_tpu_torch/csrc — with the
port's flags (``-fmad=false``) and with ``-fmad=true`` in their place —
and times each of the three kernels from both libraries on the same
inputs as chip_smoke.py's kernel phase (N = 1,000,000 x 32 trials for the
two-kernel pair, N = 8192 x 32 for the fused kernel), interleaved, over
20 launches each.  It also counts how many output entries of the
``-fmad=true`` build differ from the port's.  Prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

from chip_smoke import (N_FUSED, N_MAIN, SEED, TIMED_LAUNCHES, TRIALS,
                        MAX_ROUNDS, cuda_ms, random_pack)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fmad_cost: no CUDA device available", file=sys.stderr)
        return 1
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.ops import _build, rng
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal

    flags = ["-fmad=true" if f == "-fmad=false" else f for f in _build.FLAGS]
    libs = {"fmad_false": _build.load_library(),
            "fmad_true": _build.bind(_build.compile_library(
                flags, _build.BUILD_DIR / "fmad_true"))}
    dev = torch.device("cuda")
    r = 3
    pkey = stream_scal(SEED, r, rng.PHASE_PROPOSAL)
    vkey = stream_scal(SEED, r, rng.PHASE_VOTE)
    ckey = stream_scal(SEED, r, _COIN_SALT)

    cfg = SimConfig(n_nodes=N_MAIN, n_faulty=N_MAIN // 4, trials=TRIALS,
                    max_rounds=MAX_ROUNDS)
    m = cfg.quorum
    pack, hist1 = random_pack(cfg, dev, SEED)
    hist_f = hist1.float().contiguous()
    parts = pr.proposal_hist_plain(SEED, r, rng.PHASE_PROPOSAL, hist1, pack,
                                   m, "crash", True)
    hist2_f = parts[:, :3].float().contiguous()
    qok = (parts[:, 3] >= m).to(torch.int32).contiguous()
    fcfg = cfg.replace(n_nodes=N_FUSED, n_faulty=N_FUSED // 4)
    fpack, fhist = random_pack(fcfg, dev, SEED + 1)
    fhist_f = fhist.float().contiguous()

    calls = {
        "proposal_hist": lambda lib: (pr._launch_proposal_hist(
            lib, pkey, hist_f, pack, m, "crash", True),),
        "vote_commit": lambda lib: pr._launch_vote_commit(
            lib, vkey, ckey, r + 1, hist2_f, qok, pack, m, cfg.n_faulty,
            "reference", "crash", True),
        "fused_round": lambda lib: pr._launch_fused_round(
            lib, pkey, vkey, ckey, r + 1, fhist_f, fpack, fcfg.quorum,
            fcfg.n_faulty, "reference", "crash", True,
            pr.fused_grid(lib, fpack.shape[2], TRIALS, dev)),
    }
    out = {}
    for name, call in calls.items():
        a, b = call(libs["fmad_false"]), call(libs["fmad_true"])
        differing = sum(int((x != y).sum()) for x, y in zip(a, b))
        ms = {k: [] for k in libs}
        for _ in range(2):                    # false, true, false, true
            for k, lib in libs.items():
                ms[k].append(cuda_ms(lambda: call(lib), TIMED_LAUNCHES))
        f_ms, t_ms = min(ms["fmad_false"]), min(ms["fmad_true"])
        out[name] = dict(fmad_false_ms=f_ms, fmad_true_ms=t_ms,
                         cost=f_ms / t_ms - 1, entries_differing=differing)
        print(f"[fmad] {name}: -fmad=false {ms['fmad_false']} ms, "
              f"-fmad=true {ms['fmad_true']} ms, cost "
              f"{100 * (f_ms / t_ms - 1):.2f} %, outputs differing {differing}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"fmad_cost": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
