#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (benor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run non-zero; nothing is caught):

  1. toolchain: torch / CUDA / nvcc versions, the card, its power limit;
     build the kernels from benor_tpu_torch/csrc (one nvcc per source, in
     parallel);
  2. each kernel against its plain torch version on the card, on the same
     CUDA tensors, at the main path's shapes (N = 1,000,000 x 32 trials;
     N = 8192 x 32 for the fused round kernel; the dense tally at
     N = 2048 x 32, at bench.py's 2048 x 8 fixture and at a ragged
     R = 1000, S = 2047): every count, coin and plane word must be equal;
     times over 20 launches, the bound, and for the dense tally the
     library route (bool -> f32 cast + torch.bmm);
  3. dispatch identity: the fused kernel == proposal + sum + vote, bit for
     bit, at N = 8192 x 32;
  4. small runs on the card against the same runs on the CPU (plain
     versions), packed, unfused and dense: every trial equal;
  5. the packed main path: ``simulate``'s loop over bench.py's N = 1M
     rounds-vs-f regimes (32 trials, max_rounds = 64), then one N = 8192
     run that takes the fused kernel, with the round kernels' launch counts
     read around it; then each regime's init_state / run_consensus split
     and one profiled run;
  6. the unfused path (use_pallas_round=False) at N = 1M x 32: the same six
     regimes, each equal to its packed run in rounds, x, decided, k and
     killed, then the uniform equivocate regime and the weak-common and
     common coins, with the histogram kernels' launch counts read around
     it; one profiled run;
  7. the dense delivery path (path='auto' at N = 2048, use_pallas=True)
     at 32 trials: the six regimes scaled to this N, the biased scheduler
     at strength 1.0 and the equivocate regime, with the dense tally's
     launch count read around it (2 a round); use_pallas on against off;
     one run timed part by part and one profiled run;
  8. the kernels line, the card line, and the result line.

It imports nothing of JAX and nothing of the JAX package, and needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_MAIN = 1_000_000
N_FUSED = 8192
N_SMALL = 1000
N_DENSE = 2048            # the cap of path='auto' (dense_path_max_n)
TRIALS = 32
MAX_ROUNDS = 64
FRACS = (0.10, 0.25, 0.35, 0.40, 0.45)
SEED = 0
TIMED_LAUNCHES = 20

# The bound: peaks of one H100 SXM (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor f32; every op below is charged at it
# Operations one lane executes, counted from csrc/stream.cuh,
# csrc/round_kernels.cu and csrc/hist_kernels.cu (no lane exits early, so
# the count is data-free): threefry-2x32-20 = 2 + 20 x (add, shl, shr, or,
# xor) + 5 x 3 key adds; bits_to_uniform = 5; ndtri = 53; cf_draw = 50 +
# ndtri; one CF pair = threefry + 2 uniforms + 2 draws + 6; field loads ~2
# a plane; ballots and counts.  The dense tally does three integer adds an
# edge (one per class).
OPS_THREEFRY = 117
OPS_UNIFORM = 5
OPS_NDTRI = 53
OPS_CF_DRAW = 50 + OPS_NDTRI
OPS_CF_PAIR = OPS_THREEFRY + 2 * OPS_UNIFORM + 2 * OPS_CF_DRAW + 6


def ops_per_lane(kernel: str, planes: int = 0) -> int:
    """Operations a lane (for the dense tally: an edge) executes."""
    load = 2 * planes
    prop = load + OPS_CF_PAIR + 4 + 3 + 8
    vote = load + OPS_CF_PAIR + OPS_THREEFRY + 1 + 20 + 2 * planes + 10
    return {
        "proposal_hist": prop, "vote_commit": vote,
        "fused_round": prop + vote,
        # the pair, hq = max(m - h0 - h1, 0), three casts
        "cf_counts": OPS_CF_PAIR + 3 + 3,
        # one block, the bit, the cast
        "coin_flips": OPS_THREEFRY + 2,
        # one block, the bit, the deviation uniform, compare and select
        "weak_coin_flips": OPS_THREEFRY + 2 + OPS_UNIFORM + 2,
        # two blocks, four uniforms, three draws, the binomial split's
        # normal quantile, sums, clamps and the split (~20)
        "equiv_counts": (2 * OPS_THREEFRY + 4 * OPS_UNIFORM + 3 * OPS_CF_DRAW
                         + OPS_NDTRI + 20),
        "dense_counts": 3,
    }[kernel]


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def random_pack(cfg, device, seed):
    """A plane stack of a random mid-run state (x, decided, killed, k,
    faulty drawn on the device) -> (pack, its proposal histogram)."""
    import torch
    from benor_tpu_torch.ops.packed_round import (pack_state,
                                                  sent_hist_from_pack)
    from benor_tpu_torch.state import NetState

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.trials, cfg.n_nodes)

    def draw(hi):
        return torch.randint(0, hi, shape, generator=g, device=device)

    state = NetState(x=draw(3).to(torch.int8),
                     decided=draw(10) == 0,
                     k=draw(cfg.max_rounds + 2).to(torch.int32),
                     killed=draw(10) == 0)
    pack = pack_state(cfg, state, draw(10) == 0)
    return pack, sent_hist_from_pack(cfg, pack)


def compare(name, lanes, pairs):
    """Kernel vs plain outputs (counts, coins, plane words) -> (differing
    entries, max |diff|).  The tolerance is exact equality: the kernels
    and the plain versions run the same f32 operations in the same order,
    so any difference is a fault."""
    import torch
    n_diff, max_err = 0, 0
    for a, b in pairs:
        d = (a.to(torch.int64) - b.to(torch.int64))
        n_diff += int((d != 0).sum())
        max_err = max(max_err, int(d.abs().max()) if d.numel() else 0)
    print(f"[kernel] {name}: differing entries {n_diff} over {lanes} lanes, "
          f"max |diff| {max_err}, {'exact' if n_diff == 0 else 'MISMATCH'}")
    if n_diff:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return n_diff, max_err


def check_final(cfg, rounds, final, agreement=True):
    """Ben-Or invariants of a finished run: values in range, k within the
    rounds run, killed lanes never decide, no lane decides "?", and
    agreement (all decided lanes of a trial hold one value) -> the number
    of trials that decided both values.  ``agreement=False`` counts them
    without failing: the biased scheduler's split-bias attack and
    equivocators at small N break agreement in the JAX package too."""
    import torch
    assert 0 <= rounds <= cfg.max_rounds, rounds
    assert tuple(final.x.shape) == (cfg.trials, cfg.n_nodes)
    assert bool(((final.x >= 0) & (final.x <= 2)).all())
    assert bool(((final.k >= 0) & (final.k <= rounds + 1)).all())
    assert not bool((final.decided & final.killed).any())
    dec = final.decided
    x = final.x.to(torch.int64)
    has0 = ((x == 0) & dec).any(1)
    has1 = ((x == 1) & dec).any(1)
    split = int((has0 & has1).sum())
    assert not (agreement and split), "agreement violated"
    assert not bool(((x == 2) & dec).any()), "decided on '?'"
    return split


def trials_differing(a, b) -> int:
    """Trials in which two final states differ in x, decided, k or
    killed."""
    diff = sum((getattr(a, n).cpu() != getattr(b, n).cpu()).any(1)
               for n in ("x", "decided", "k", "killed"))
    return int(diff.clamp(max=1).sum())


def breakdown(tag, name, run, t_run, ours):
    """Profile one call of ``run`` -> a ``[breakdown]`` line: device busy
    time, the share of the named kernels, and the top device entries."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (an aten op's entry repeats its kernels' time)
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    top = ", ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in evs[:8])
    ours_ms = sum(dev_us(e) for e in evs if "_kernel(" in e.key
                  and any(k in e.key for k in ours)) / 1e3
    print(f"[breakdown] {tag} {name}: profiled run_consensus: device busy "
          f"{busy_ms:.3f} ms (port kernels {ours_ms:.3f} ms) = "
          f"{busy_ms / 1e3 / t_run:.4f} of the unprofiled run_consensus; "
          f"top device time: {top}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from benor_tpu_torch import SimConfig, simulate
    import numpy as np

    from benor_tpu_torch.ops import _build, rng, scheduler, tally
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import sampling
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import (_COIN_SALT, _EQUIV_SALT_OFFSET,
                                            stream_scal)
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs, random_inputs

    dev = torch.device("cuda")
    # --- 1. toolchain ----------------------------------------------------
    nvcc = [ln for ln in sh([_build.nvcc_path(), "--version"]).splitlines()
            if "release" in ln][0]
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc} | {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} | "
          f"{smi}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"[build] {len(_build.sources())} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels = {}

    def record(name, lanes, planes, nbytes, n_diff, max_err, ms, plain_ms,
               library_ms=None):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = lanes * ops_per_lane(name, planes) / F32_OPS_PER_S * 1e3
        src = ("round" if name in pr.KERNELS
               else "tally" if name in dk.KERNELS else "hist")
        kernels[name] = dict(
            name=name, route="cuda",
            source=f"benor_tpu_torch/csrc/{src}_kernels.cu",
            replaces=REPLACES[name], launches=0, max_abs_err=max_err,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, match="exact", differing=n_diff)
        lib_txt = ("" if library_ms is None
                   else f"library {library_ms:.4f} ms, ")
        print(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"{lib_txt}bound {max(t_bytes, t_ops):.4f} ms (bytes "
              f"{t_bytes:.4f} for {nbytes} B, operations {t_ops:.4f} for "
              f"{ops_per_lane(name, planes)} a lane)")

    # --- 2. kernels vs plain versions on the card -------------------------
    cfg = SimConfig(n_nodes=N_MAIN, n_faulty=N_MAIN // 4, trials=TRIALS,
                    max_rounds=MAX_ROUNDS)
    m, r = cfg.quorum, 3
    pack, hist1 = random_pack(cfg, dev, SEED)
    t, planes, n_w = pack.shape
    lanes = t * n_w * 32
    pkey = stream_scal(SEED, r, rng.PHASE_PROPOSAL)
    vkey = stream_scal(SEED, r, rng.PHASE_VOTE)
    ckey = stream_scal(SEED, r, _COIN_SALT)
    modes = dict(fault_model="crash", freeze=True)
    pack_bytes = pack.numel() * 4
    blocks = lib.benor_round_blocks(n_w)

    parts_k = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist1, pack, m,
                               **modes)
    parts_p = pr.proposal_hist_plain(SEED, r, rng.PHASE_PROPOSAL, hist1,
                                     pack, m, **modes)
    torch.cuda.synchronize()
    res = compare("proposal_hist", lanes, [(parts_k, parts_p)])
    hist_f = count_vecs(hist1)
    ms = cuda_ms(lambda: pr._launch_proposal_hist(
        lib, pkey, hist_f, pack, m, **modes), TIMED_LAUNCHES)
    plain = cuda_ms(lambda: pr.proposal_hist_plain(
        SEED, r, rng.PHASE_PROPOSAL, hist1, pack, m, **modes), TIMED_LAUNCHES)
    record("proposal_hist", lanes, planes,
           pack_bytes + t * 3 * 4 + blocks * t * pr.PROP_COLS * 4,
           *res, ms, plain)

    hist2 = parts_p[:, :3]
    qok = parts_p[:, 3] >= m
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="reference", **modes)
    new_k, vparts_k = pr.vote_commit(SEED, r, rng.PHASE_VOTE, hist2, pack,
                                     qok, **vote)
    new_p, vparts_p = pr.vote_commit_plain(SEED, r, rng.PHASE_VOTE, hist2,
                                           pack, qok, **vote)
    torch.cuda.synchronize()
    res = compare("vote_commit", lanes, [(new_k, new_p),
                                         (vparts_k, vparts_p)])
    hist2_f = count_vecs(hist2)
    qok_i = qok.to(torch.int32).contiguous()
    vargs = (vkey, ckey, r + 1, hist2_f, qok_i, pack, m, cfg.n_faulty,
             "reference", "crash", True)
    ms = cuda_ms(lambda: pr._launch_vote_commit(lib, *vargs), TIMED_LAUNCHES)
    plain = cuda_ms(lambda: pr.vote_commit_plain(
        SEED, r, rng.PHASE_VOTE, hist2, pack, qok, **vote), TIMED_LAUNCHES)
    record("vote_commit", lanes, planes,
           2 * pack_bytes + t * 4 * 4 + blocks * t * pr.VOTE_COLS * 4,
           *res, ms, plain)
    del pack, new_k, new_p

    fcfg = cfg.replace(n_nodes=N_FUSED, n_faulty=N_FUSED // 4)
    fm_ = fcfg.quorum
    fpack, fhist = random_pack(fcfg, dev, SEED + 1)
    ft, fplanes, fn_w = fpack.shape
    flanes = ft * fn_w * 32
    fvote = dict(m=fm_, n_faulty=fcfg.n_faulty, rule="reference", **modes)
    out_k = pr.fused_round(SEED, r, fhist, fpack, **fvote)
    out_p = pr.fused_round_plain(SEED, r, fhist, fpack, **fvote)
    torch.cuda.synchronize()
    res = compare("fused_round", flanes, list(zip(out_k, out_p)))
    fhist_f = count_vecs(fhist)
    fargs = (pkey, vkey, ckey, r + 1, fhist_f, fpack, fm_, fcfg.n_faulty,
             "reference", "crash", True)
    ms = cuda_ms(lambda: pr._launch_fused_round(lib, *fargs), TIMED_LAUNCHES)
    plain = cuda_ms(lambda: pr.fused_round_plain(
        SEED, r, fhist, fpack, **fvote), TIMED_LAUNCHES)
    record("fused_round", flanes, fplanes,
           2 * fpack.numel() * 4 + ft * 3 * 4
           + ft * (pr.PROP_COLS + pr.VOTE_COLS) * 4, *res, ms, plain)

    # the histogram kernels at N = 1M x 32, on the unfused path's operands
    hlanes = TRIALS * N_MAIN
    f40 = int(0.40 * N_MAIN)                 # balanced f = 0.40, round 1
    bal_hist = torch.tensor([[N_MAIN // 2, N_MAIN // 2, 0]] * TRIALS,
                            dtype=torch.int32, device=dev)
    m40 = N_MAIN - f40
    res = compare("cf_counts", hlanes, [(
        hk.cf_counts(SEED, r, rng.PHASE_PROPOSAL, bal_hist, m40, N_MAIN),
        hk.cf_counts_plain(SEED, r, rng.PHASE_PROPOSAL, bal_hist, m40,
                           N_MAIN))])
    bal_f = count_vecs(bal_hist)
    ms = cuda_ms(lambda: hk._launch_cf_counts(lib, pkey, bal_f, m40, N_MAIN),
                 TIMED_LAUNCHES)
    plain = cuda_ms(lambda: hk.cf_counts_plain(
        SEED, r, rng.PHASE_PROPOSAL, bal_hist, m40, N_MAIN), TIMED_LAUNCHES)
    record("cf_counts", hlanes, 0, hlanes * 3 * 4 + TRIALS * 3 * 4, *res, ms,
           plain)

    res = compare("coin_flips", hlanes, [(
        hk.coin_flips(SEED, r, TRIALS, N_MAIN, dev),
        hk.coin_flips_plain(SEED, r, TRIALS, N_MAIN, dev))])
    ms = cuda_ms(lambda: hk._launch_coin_flips(lib, ckey, TRIALS, N_MAIN,
                                               dev), TIMED_LAUNCHES)
    plain = cuda_ms(lambda: hk.coin_flips_plain(SEED, r, TRIALS, N_MAIN, dev),
                    TIMED_LAUNCHES)
    record("coin_flips", hlanes, 0, hlanes, *res, ms, plain)

    # equiv_uniform_f0.20's round-1 operands: the honest histogram of
    # balanced inputs with the first F lanes equivocating, all alive
    ecfg = SimConfig(n_nodes=N_MAIN, n_faulty=int(0.2 * N_MAIN),
                     trials=TRIALS, fault_model="equivocate")
    efaults = FaultSpec.first_f(ecfg, device=dev)
    est = init_state(ecfg, balanced_inputs(TRIALS, N_MAIN), efaults)
    e_alive = ~est.killed
    e_hist = tally.class_histogram(est.x, e_alive & ~efaults.faulty)
    n_equiv = (efaults.faulty & e_alive).sum(-1, dtype=torch.int32)
    print(f"[operands] equiv_uniform_f0.20 round 1: hist {e_hist[0].tolist()}"
          f" n_equiv {int(n_equiv[0])} m {ecfg.quorum}")
    res = compare("equiv_counts", hlanes, [(
        hk.equiv_counts(SEED, r, rng.PHASE_VOTE, e_hist, n_equiv,
                        ecfg.quorum, N_MAIN),
        hk.equiv_counts_plain(SEED, r, rng.PHASE_VOTE, e_hist, n_equiv,
                              ecfg.quorum, N_MAIN))])
    e_hist_f, ne_f = count_vecs(e_hist), count_vecs(n_equiv)
    ekey2 = stream_scal(SEED, r, rng.PHASE_VOTE + _EQUIV_SALT_OFFSET)
    ms = cuda_ms(lambda: hk._launch_equiv_counts(
        lib, vkey, ekey2, e_hist_f, ne_f, ecfg.quorum, N_MAIN),
        TIMED_LAUNCHES)
    plain = cuda_ms(lambda: hk.equiv_counts_plain(
        SEED, r, rng.PHASE_VOTE, e_hist, n_equiv, ecfg.quorum, N_MAIN),
        TIMED_LAUNCHES)
    record("equiv_counts", hlanes, 0,
           hlanes * 3 * 4 + TRIALS * 4 * 4, *res, ms, plain)
    del est, efaults, e_alive

    eps = 0.5
    shared = rng.coin_flips(SEED, r, rng.ids(TRIALS, device=dev),
                            rng.ids(1, device=dev), common=True)[:, 0]
    res = compare("weak_coin_flips", hlanes, [(
        hk.weak_coin_flips(SEED, r, TRIALS, N_MAIN, eps, shared),
        hk.weak_coin_flips_plain(SEED, r, TRIALS, N_MAIN, eps, shared))])
    shared_i = shared.to(torch.int32).contiguous()
    ms = cuda_ms(lambda: hk._launch_weak_coin_flips(
        lib, ckey, TRIALS, N_MAIN, eps, shared_i), TIMED_LAUNCHES)
    plain = cuda_ms(lambda: hk.weak_coin_flips_plain(
        SEED, r, TRIALS, N_MAIN, eps, shared), TIMED_LAUNCHES)
    record("weak_coin_flips", hlanes, 0, hlanes + TRIALS * 4, *res, ms,
           plain)
    torch.cuda.empty_cache()

    # the dense tally: bench.py's fixture (mask Bernoulli 0.8, sent uniform
    # in {0, 1, 2}, alive Bernoulli 0.9, made with numpy from the seed) at
    # its own T = 8, a ragged shape for the byte tails, and last the main
    # path's T = 32, whose times go into the kernels line
    def dense_case(t, n_recv, n_send):
        rs = np.random.default_rng(SEED)
        mask = rs.random((t, n_recv, n_send), dtype=np.float32) < 0.8
        sent = rs.integers(0, 3, (t, n_send)).astype(np.int8)
        alive = rs.random((t, n_send)) < 0.9
        return [torch.from_numpy(a).to(dev) for a in (mask, sent, alive)]

    for t_d, r_d, s_d in ((8, N_DENSE, N_DENSE), (TRIALS, 1000, 2047),
                          (TRIALS, N_DENSE, N_DENSE)):
        ops = dense_case(t_d, r_d, s_d)
        edges = t_d * r_d * s_d
        got = dk.dense_counts(*ops)
        want = dk.dense_counts_plain(*ops)
        via_bmm = tally.dense_counts(*ops)
        torch.cuda.synchronize()
        res = compare(f"dense_counts T={t_d} R={r_d} S={s_d}", edges,
                      [(got, want), (via_bmm, want)])
        ms = cuda_ms(lambda: dk._launch_dense_counts(lib, *ops),
                     TIMED_LAUNCHES)
        plain = cuda_ms(lambda: dk.dense_counts_plain(*ops), TIMED_LAUNCHES)
        # the library route, timed whole: three compare-and-cast one-hot
        # columns, the bool -> f32 cast of the mask, torch.bmm, the int cast
        lib_ms = cuda_ms(lambda: tally.dense_counts(*ops), TIMED_LAUNCHES)
        nbytes = edges + 2 * t_d * s_d + t_d * r_d * 3 * 4
        if (t_d, r_d) != (TRIALS, N_DENSE):
            print(f"[time] dense_counts T={t_d} R={r_d} S={s_d}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library (cast + bmm) "
                  f"{lib_ms:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {nbytes} "
                  f"B); the same buffers every launch, so a mask under the "
                  f"50 MB L2 is read from it")
        else:
            record("dense_counts", edges, 0, nbytes, *res, ms, plain, lib_ms)
        del ops, got, want, via_bmm
    torch.cuda.empty_cache()

    # --- 3. dispatch identity: fused == proposal + sum + vote -------------
    parts_a = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, fhist, fpack,
                               fm_, **modes)
    two_pack, two_b = pr.vote_commit(SEED, r, rng.PHASE_VOTE,
                                     parts_a[:, :3], fpack,
                                     parts_a[:, 3] >= fm_, **fvote)
    same = (torch.equal(out_k[0], two_pack) and torch.equal(out_k[1], parts_a)
            and torch.equal(out_k[2], two_b))
    print(f"[dispatch] fused_round vs proposal_hist + sum + vote_commit at "
          f"N={N_FUSED} T={TRIALS}: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("fused and two-kernel rounds differ")

    # --- 4. small runs on the card vs the same runs on the CPU ------------
    small = [
        ("packed f=0.45", dict(n_faulty=450, use_pallas_round=True), False),
        ("unfused equivocate f=0.20",
         dict(n_faulty=200, fault_model="equivocate"), True),
        ("unfused weak_common eps=0.5 f=0.45",
         dict(n_faulty=450, coin_mode="weak_common", coin_eps=0.5), False),
    ]
    old = sampling.EXACT_TABLE_MAX
    sampling.EXACT_TABLE_MAX = 4          # force the CF regime at N = 1000
    try:
        for tag, kw, first_f in small:
            kw = {"use_pallas_round": False, **kw}
            scfg = SimConfig(n_nodes=N_SMALL, trials=8, delivery="quorum",
                             scheduler="uniform", path="histogram",
                             use_pallas_hist=True, max_rounds=MAX_ROUNDS,
                             seed=SEED, **kw)
            assert tally.pallas_round_active(scfg) == scfg.use_pallas_round
            outs = {}
            for d in ("cpu", "cuda"):
                f = (FaultSpec.first_f(scfg, device=d) if first_f
                     else FaultSpec.none(scfg.trials, N_SMALL, device=d))
                st = init_state(scfg, balanced_inputs(scfg.trials, N_SMALL),
                                f)
                rr, fin = run_consensus(scfg, st, f)
                check_final(scfg, rr, fin)
                outs[d] = (rr, fin)
            (rc, fc), (rg, fg) = outs["cpu"], outs["cuda"]
            diff = trials_differing(fc, fg)
            print(f"[small] {tag} N={N_SMALL} T=8: rounds cpu {rc} cuda {rg},"
                  f" trials differing {diff} of 8")
            if rc != rg or diff:
                raise SystemExit(f"{tag}: card and CPU runs disagree")
    finally:
        sampling.EXACT_TABLE_MAX = old

    # the dense path at N = 60, 16 trials: F = 15 crashed from birth on iid
    # inputs (the biased scheduler, and equivocators at this N, may decide
    # both values in a trial by design), then a two-round run on balanced
    # inputs with F = 24 and no crashes
    n_s, t_s = 60, 16
    svals = np.random.default_rng(3).integers(0, 2, (t_s, n_s), np.int8)
    dense_small = [
        ("dense uniform", dict(n_faulty=15), True, True),
        ("dense biased 1.0", dict(n_faulty=15, scheduler="biased",
                                  adversary_strength=1.0), True, False),
        ("dense equivocate", dict(n_faulty=15, fault_model="equivocate"),
         True, False),
        ("dense uniform balanced", dict(n_faulty=24), False, True),
    ]
    for tag, kw, crashed, agree in dense_small:
        scfg = SimConfig(n_nodes=n_s, trials=t_s, max_rounds=48,
                         delivery="quorum", path="dense", seed=3,
                         use_pallas=True, **kw)
        vals = svals if crashed else balanced_inputs(t_s, n_s)
        outs = {}
        for d in ("cpu", "cuda"):
            f = (FaultSpec.first_f(scfg, device=d) if crashed
                 else FaultSpec.none(t_s, n_s, device=d))
            rr, fin = run_consensus(scfg, init_state(scfg, vals, f), f)
            check_final(scfg, rr, fin, agree)
            outs[d] = (rr, fin)
        (rc, fc), (rg, fg) = outs["cpu"], outs["cuda"]
        diff = trials_differing(fc, fg)
        print(f"[small] {tag} N={n_s} F={scfg.n_faulty} T={t_s}: rounds cpu "
              f"{rc} cuda {rg}, trials differing {diff} of {t_s}")
        if rc != rg or diff:
            raise SystemExit(f"{tag}: card and CPU runs disagree")

    # --- 5. the packed main path ---------------------------------------------
    base = dict(trials=TRIALS, max_rounds=MAX_ROUNDS, delivery="quorum",
                scheduler="uniform", path="histogram", fault_model="crash",
                seed=SEED, use_pallas_hist=True, use_pallas_round=True)
    regimes = []
    f = int(0.2 * N_MAIN)
    cfg_iid = SimConfig(n_nodes=N_MAIN, n_faulty=f, **base)
    regimes.append(("iid_crash_f0.20", cfg_iid,
                    random_inputs(SEED, TRIALS, N_MAIN),
                    FaultSpec.first_f(cfg_iid, device=dev)))
    bal = balanced_inputs(TRIALS, N_MAIN)
    for frac in FRACS:
        c = SimConfig(n_nodes=N_MAIN, n_faulty=int(frac * N_MAIN), **base)
        regimes.append((f"balanced_f{frac:.2f}", c, bal,
                        FaultSpec.none(TRIALS, N_MAIN, device=dev)))
    c = SimConfig(n_nodes=N_FUSED, n_faulty=N_FUSED // 4, **base)
    regimes.append((f"balanced_f0.25_n{N_FUSED}", c,
                    balanced_inputs(TRIALS, N_FUSED),
                    FaultSpec.none(TRIALS, N_FUSED, device=dev)))
    torch.cuda.synchronize()

    def drive(tag, name, c, vals, fl, agreement=True):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        split = check_final(c, rounds, fin, agreement)
        live = int((~fin.killed).sum())
        dec = int(fin.decided.sum()) / max(live, 1)
        print(f"[{tag}] {name}: N={c.n_nodes} T={c.trials} rounds {rounds} "
              f"decided {dec:.6f} trials split {split} wall {sec:.4f} s "
              f"trials/s {c.trials / sec:.3f} peak_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        return rounds, fin

    def read_launches(tag, table):
        launches = {k: fn.launches for k, fn in table.items()}
        print(f"[{tag}] launches {launches}")
        for name, n in launches.items():
            if n == 0:
                raise SystemExit(f"{name} never launched on the {tag} path")
            kernels[name]["launches"] = n

    packed_out = {}
    pr.reset_launches()
    hk.reset_launches()
    for name, c, vals, fl in regimes:
        packed_out[name] = drive("main", name, c, vals, fl)
    read_launches("main", pr.KERNELS)

    # where the time goes: state build vs the run, per regime
    t_runs = {}
    for name, c, vals, fl in regimes:
        t0 = time.perf_counter()
        st = init_state(c, vals, fl)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        rounds, _ = run_consensus(c, st, fl)
        torch.cuda.synchronize()
        t_run = t_runs[name] = time.perf_counter() - t0
        print(f"[split] {name}: init_state {t_init:.4f} s, run_consensus "
              f"{t_run:.4f} s ({rounds} rounds, {c.trials / t_run:.3f} "
              f"trials/s over run_consensus alone)")
    name, c, vals, fl = regimes[-2]                      # balanced_f0.45
    st = init_state(c, vals, fl)
    breakdown("main", name, lambda: run_consensus(c, st, fl), t_runs[name],
              tuple(pr.KERNELS))
    del st

    # --- 6. the unfused path at full width -----------------------------------
    unfused = [(name, c.replace(use_pallas_round=False), vals, fl)
               for name, c, vals, fl in regimes[:-1]]
    eq = SimConfig(n_nodes=N_MAIN, n_faulty=int(0.2 * N_MAIN),
                   **{**base, "fault_model": "equivocate",
                      "use_pallas_round": False})
    unfused.append(("equiv_uniform_f0.20", eq, bal,
                    FaultSpec.first_f(eq, device=dev)))
    for coin, extra in (("weak_common", dict(coin_eps=0.5)),
                        ("common", {})):
        c = SimConfig(n_nodes=N_MAIN, n_faulty=int(0.40 * N_MAIN),
                      coin_mode=coin, **{**base, "use_pallas_round": False},
                      **extra)
        unfused.append((f"balanced_f0.40_{coin}", c, bal,
                        FaultSpec.none(TRIALS, N_MAIN, device=dev)))
    pr.reset_launches()
    hk.reset_launches()
    for name, c, vals, fl in unfused:
        assert not tally.pallas_round_active(c)
        rounds, fin = drive("unfused", name, c, vals, fl)
        if name in packed_out:
            p_rounds, p_fin = packed_out.pop(name)
            diff = trials_differing(fin, p_fin)
            print(f"[unfused] {name} vs packed: rounds {rounds} vs "
                  f"{p_rounds}, trials differing {diff} of {c.trials}")
            if rounds != p_rounds or diff:
                raise SystemExit(f"{name}: unfused and packed runs differ")
        del fin
    read_launches("unfused", hk.KERNELS)
    del packed_out
    # balanced f = 0.45 (private coin) and f = 0.40 under the common coin
    for name, c, vals, fl in (unfused[-4], unfused[-1]):
        st = init_state(c, vals, fl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds, _ = run_consensus(c, st, fl)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        print(f"[split] unfused {name}: run_consensus {t_run:.4f} s "
              f"({rounds} rounds, {c.trials / t_run:.3f} trials/s over "
              f"run_consensus alone)")
        breakdown("unfused", name, lambda: run_consensus(c, st, fl), t_run,
                  tuple(hk.KERNELS))
    del st, regimes, unfused, bal, vals, fl
    torch.cuda.empty_cache()

    # --- 7. the dense delivery path at full width --------------------------
    dbase = dict(trials=TRIALS, max_rounds=MAX_ROUNDS, delivery="quorum",
                 scheduler="uniform", path="auto", fault_model="crash",
                 seed=SEED, use_pallas=True)
    dbal = balanced_inputs(TRIALS, N_DENSE)
    dnone = FaultSpec.none(TRIALS, N_DENSE, device=dev)

    def dcfg(frac, **kw):
        return SimConfig(n_nodes=N_DENSE, n_faulty=int(frac * N_DENSE),
                         **{**dbase, **kw})

    c = dcfg(0.20)
    dense = [("iid_crash_f0.20", c, random_inputs(SEED, TRIALS, N_DENSE),
              FaultSpec.first_f(c, device=dev), True)]
    dense += [(f"balanced_f{frac:.2f}", dcfg(frac), dbal, dnone, True)
              for frac in FRACS]
    # the split-bias attack decides both values in a trial by design
    dense.append(("biased1.0_f0.25",
                  dcfg(0.25, scheduler="biased", adversary_strength=1.0),
                  dbal, dnone, False))
    c = dcfg(0.20, fault_model="equivocate")
    dense.append(("equiv_uniform_f0.20", c, dbal,
                  FaultSpec.first_f(c, device=dev), True))
    dk.reset_launches()
    hk.reset_launches()
    pr.reset_launches()
    dense_out, dense_rounds = {}, 0
    for name, c, vals, fl, agree in dense:
        assert c.resolved_path == "dense" and tally.dense_gather_needed(c)
        dense_out[name] = drive("dense", name, c, vals, fl, agree)
        dense_rounds += dense_out[name][0]
    read_launches("dense", dk.KERNELS)
    print(f"[dense] rounds run {dense_rounds}: dense_counts launched "
          f"{dk.dense_counts.launches} times (2 a round)")
    if dk.dense_counts.launches != 2 * dense_rounds:
        raise SystemExit("dense_counts launches != 2 x the rounds run")
    if any(fn.launches for fn in (*hk.KERNELS.values(),
                                  *pr.KERNELS.values())):
        raise SystemExit("a histogram kernel launched on the dense path")

    # use_pallas on (the kernel) against off (the f32 matrix product)
    name, c, vals, fl, agree = dense[-3]                 # balanced_f0.45
    rounds_on, fin_on = dense_out[name]
    rounds_off, fin_off = drive("dense", name + " use_pallas=False",
                                c.replace(use_pallas=False), vals, fl, agree)
    diff = trials_differing(fin_on, fin_off)
    print(f"[dense] {name} use_pallas on vs off: rounds {rounds_on} vs "
          f"{rounds_off}, trials differing {diff} of {c.trials}")
    if rounds_on != rounds_off or diff:
        raise SystemExit("use_pallas on and off differ on the dense path")
    del dense_out, fin_on, fin_off

    # where the time goes: one run, then its parts timed alone at the
    # run's shapes (a round draws two delay tensors, builds two masks and
    # tallies twice)
    st = init_state(c, vals, fl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds, _ = run_consensus(c, st, fl)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    print(f"[split] dense {name}: run_consensus {t_run:.4f} s ({rounds} "
          f"rounds, {c.trials / t_run:.3f} trials/s over run_consensus "
          f"alone)")
    tid, nid = rng.ids(TRIALS, device=dev), rng.ids(N_DENSE, device=dev)

    def timed_with_peak(fn):
        """(ms, peak MiB allocated above what was live before) of fn."""
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fn, 3)
        return ms, (torch.cuda.max_memory_allocated() - live) / 2**20

    ms_edge, mem_edge = timed_with_peak(
        lambda: rng.edge_uniforms(SEED, 1, 0, tid, nid, nid))
    delays = rng.edge_uniforms(SEED, 1, 0, tid, nid, nid)
    ms_top, mem_top = timed_with_peak(
        lambda: scheduler._top_m_mask(delays, c.quorum))
    srt = torch.sort(delays, dim=-1, stable=True).values
    ties = int((srt[..., c.quorum - 1] == srt[..., c.quorum]).sum())
    del delays, srt
    ms_round = t_run / rounds * 1e3
    ms_k = kernels["dense_counts"]["ms"]
    rest = ms_round - 2 * (ms_edge + ms_top + ms_k)
    print(f"[parts] dense {name}: a round {ms_round:.3f} ms = 2 x "
          f"(edge_uniforms {ms_edge:.3f} ms + top-m sort and scatter "
          f"{ms_top:.3f} ms + dense_counts {ms_k:.4f} ms) + the rest "
          f"{rest:.3f} ms (bias / inf fill / alive masks, the round's where "
          f"chains, the fold_in coins, the host sync); edge_uniforms allocates "
          f"{mem_edge:.1f} MiB at its peak (its output included), top-m "
          f"{mem_top:.1f} MiB; rows with "
          f"equal delays at the m-th place: {ties} of {TRIALS * N_DENSE}")
    breakdown("dense", name, lambda: run_consensus(c, st, fl), t_run,
              tuple(dk.KERNELS))

    # --- 8. the kernels line, the card, the result -------------------------
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


REPLACES = {
    "proposal_hist": "benor_tpu/ops/pallas_round.py:1024",
    "vote_commit": "benor_tpu/ops/pallas_round.py:1105",
    "fused_round": "benor_tpu/ops/pallas_round.py:1195",
    "cf_counts": "benor_tpu/ops/pallas_hist.py:412",
    "coin_flips": "benor_tpu/ops/pallas_hist.py:244",
    "equiv_counts": "benor_tpu/ops/pallas_hist.py:365",
    "weak_coin_flips": "benor_tpu/ops/pallas_hist.py:333",
    "dense_counts": "benor_tpu/ops/pallas_tally.py:76",
}

if __name__ == "__main__":
    sys.exit(main())
