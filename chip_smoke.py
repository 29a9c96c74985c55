#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (benor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run non-zero; nothing is caught):

  1. toolchain: torch / CUDA / nvcc versions, the card, its power limit;
     build the kernels from benor_tpu_torch/csrc (one nvcc per source, in
     parallel);
  2. each kernel against its plain torch version on the card, on the same
     CUDA tensors, at the main path's shapes (N = 1,000,000 x 32 trials;
     the fused round kernel at each shape of FUSED_FAMILY; the dense
     tally at N = 2048 x 32, at bench.py's 2048 x 8 fixture and at a ragged
     R = 1000, S = 2047): every count, coin and plane word must be equal;
     three repeats of the mean over 20 launches, the bound (the
     operations this run's inputs need, with the whole-draw count beside
     it),
     and for the dense tally the library route (bool -> f32 cast +
     torch.bmm).  The two-kernel round pair also runs on two more
     N = 1M x 32 fixtures, one edge histogram a trial and whole warps
     inactive; cf_counts and equiv_counts run on three fixtures (the
     unfused path's balanced operands, one edge histogram a trial, a
     ragged N = 1,000,003 x 7) and at the grid's corners (T = 1 with
     N = 1 and N = 1,000,003; T = 1500, N = 33); the coins on N = 1M x
     32, the ragged N = 1,000,003 x 7, the same corners and T = 7, N = 5
     (every row unaligned), the weak coin at eps 0.25, 0.5 and 0.75, with
     their grid (blocks a trial, nodes a thread); the registers, spills,
     shared memory, SASS mix and pipe floors at the measured clocks.sm of
     the round kernels, of the counts kernels and of the coins
     (benor_tpu_torch/ops/sass.py);
  3. the fused round at each shape of its family (N = 8192 at T = 32, 8
     and 1; T x Np = 2^18 at N = 1024 and 512; the upstream N = 10 x 1,
     its latency probe): the kernel == its plain version == proposal + sum
     + vote (the dispatch's other route), bit for bit; its cluster grid
     (C blocks of W warps a trial, packed_round.fused_grid) printed; the
     kernel, the fused wrapper and the two-kernel route timed side by
     side, as every kernel is and queued (``cuda_ms``);
     its registers, SASS and pipe floors at N = 8192 x 32 with the probe's
     time beside them;
  4. small runs on the card against the same runs on the CPU (plain
     versions), packed, unfused and dense: every trial equal;
  5. the packed main path: ``simulate``'s loop over bench.py's N = 1M
     rounds-vs-f regimes (32 trials, max_rounds = 64), then two N = 8192
     runs that take the fused kernel, at 32 trials and at one (one fused
     launch a round, no other round kernel), with the round kernels'
     launch counts read around them; then each run's init_state /
     run_consensus split and one profiled run;
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
  8. the facade and ``delivery='all'`` (the JAX package's default), plain
     torch with no kernel: each scenario of tests/test_scenarios.py and
     the upstream default launch through ``launch_network`` on the card
     and on the CPU, state for state equal, the livelock scenario again
     with ``poll_rounds=1`` equal to its one-shot run (``[api]``); the
     equivocator split's card-against-CPU differences; the six regimes at
     N = 1M x 32 with ``delivery='all'`` and equivocate at F = 4096 (the
     exact table) and 200,000 (the quantile) on balanced inputs
     (agreement) and all-1 inputs (validity), with no kernel launched,
     the ``init_state`` / ``run_consensus`` split and two profiled runs;
     crash at N = 65,536 x 32 and equivocate at N = 8192 x 8 (both
     samplers) equal on the card and the CPU (``[all]``);
  9. ``[item8]``: equivocation, the shared coins and the count adversaries
     in the round kernels.  Every new mode instantiation of
     proposal_hist / vote_commit against its plain version on N = 1M x 32
     fixtures, and of fused_round on its shape family against its plain
     version and the two-kernel route, each timed once beside the main
     path's instantiation on the same kind of fixture, with its bound and
     its registers and SASS; bench.py's nine regimes that run those
     branches (bench.py:337-406) at N = 1M x 32 with the launch counts
     read around them (targeted_f0.50 and equiv_3f_super must decide no
     lane; no histogram kernel may run), their init_state / run_consensus
     split and two profiled runs; packed against unfused on the four
     regimes where both share every bit; every new mode at N = 8192 x 8
     and 16,384 x 4 on the card against the CPU;
 10. the kernels line, the card line, and the result line.

It imports nothing of JAX and nothing of the JAX package, and needs one card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

N_MAIN = 1_000_000
N_FUSED = 8192
N_SMALL = 1000
N_DENSE = 2048            # the cap of path='auto' (dense_path_max_n)
N_RAGGED, T_RAGGED = 1_000_003, 7     # the histogram kernels' ragged fixture
# the histogram kernels' grid corners (T, N): one lane, one trial of a
# ragged N, more trials than a wave holds blocks; and for the coins every
# row unaligned with a ragged end (N = 5)
GRID_CORNERS = ((1, 1), (1, N_RAGGED), (1500, 33))
COIN_CORNERS = GRID_CORNERS + ((7, 5),)
COIN_EPS = (0.25, 0.5, 0.75)          # the weak coin's deviation rates
TRIALS = 32
MAX_ROUNDS = 64
FRACS = (0.10, 0.25, 0.35, 0.40, 0.45)
SEED = 0
ROUND = 3                 # the round whose stream keys the fixtures use
TIMED_LAUNCHES = 20
# ~10 ms at the H100's 1980 MHz: longer than the host takes to queue
# TIMED_LAUNCHES calls of any timed function here (cuda_ms(queued=True))
LEAD_CYCLES = 20_000_000
# the fused round's shape family (T, N): its cap N = 8192 at T = 32, 8 and
# 1; T x Np = 2^18 at Np = 1024 and 512; the upstream default N = 10 (one
# trial, padded to 512 nodes: the latency probe)
FUSED_FAMILY = ((32, 8192), (8, 8192), (1, 8192), (256, 1024), (512, 512),
                (1, 10))
MODES = dict(fault_model="crash", freeze=True)
# the packed main path's settings but N and F (bench.py's regimes)
MAIN_RUN = dict(trials=TRIALS, max_rounds=MAX_ROUNDS, delivery="quorum",
                scheduler="uniform", path="histogram", fault_model="crash",
                seed=SEED, use_pallas_hist=True, use_pallas_round=True)

# The bound: peaks of one H100 SXM (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor f32; every op below is charged at it
# Operations the functions need on this run's inputs, counted from
# csrc/stream.cuh and csrc/*_kernels.cu (an IEEE divide, square root or
# log counts as one):
#  - threefry-2x32-20 = 2 + 20 x (add, shl, shr, or, xor) + 5 x 3 key adds;
#    bits_to_uniform = 5;
#  - the normal quantile (ndtri_clipped) by the branch its uniform takes:
#    q = p - 0.5, |q|, the compare (3), then central (|q| <= 0.425: r_c,
#    num_c and den_c by Horner, q * num_c, the divide: 16) or middle tail
#    (1 - p, min, log, negate, sqrt, r_m, num_m and den_m by Horner, the
#    sign, the divide: 19).  bits_to_uniform clips u to [1e-7, 1 - 1e-7],
#    which keeps r_t <= 4.02, so AS241's far tail (r_t > 5) is never needed;
#  - a CF draw's population and quorum terms (cf_pop, and cf_terms of the
#    first draw of a pair) once a trial: 55 for a pair.  A lane then needs
#    10 + its quantile for each draw (cf_sample); the terms of a sample
#    size that is the lane's own (the second draw of a pair: max(m - p0,
#    0); equivocate's rem and rem - h0), 23 (cf_terms), once for each
#    distinct (trial, sample size) that this run's lanes draw;
#  - a round kernel reads 5 planes a lane (x0, x1, decided, killed,
#    faulty: shift and mask, 2 each); the vote sets 4 new bits a lane and
#    rebuilds each k plane of a word with 2 word operations; the rest of a
#    lane's logic, ballots and counts is 15 (proposal) or 31 (vote);
#  - the round kernels need a CF pair only for the lanes that read it (see
#    lane_needs), the coin only for lanes that coin; the dense tally does
#    three integer adds an edge (one per class).
OPS_THREEFRY = 117
OPS_UNIFORM = 5
OPS_NDTRI_CENTRAL = 3 + 16
OPS_NDTRI_TAIL = 3 + 19
OPS_CF_SAMPLE = 10
OPS_CF_TERMS = 23
# a pair's lane work without its quantiles and its sample-size terms
OPS_CF_PAIR_LANE = OPS_THREEFRY + 2 * OPS_UNIFORM + 2 * OPS_CF_SAMPLE
OPS_CF_TRIAL = 55
OPS_READ_PLANES = 5 * 2
# Sample sizes a block of cf_counts / equiv_counts tabulates its per-lane
# terms over (csrc/hist_kernels.cu kCfWindow, kEquivWindow).
CF_WINDOW, EQUIV_WINDOW = 2048, 1024


def ops_quantiles(n: int, tails: int) -> int:
    """Operations of ``n`` normal quantiles, ``tails`` of them in the
    middle tail."""
    return (n - tails) * OPS_NDTRI_CENTRAL + tails * OPS_NDTRI_TAIL


def ops_needed(kernel: str, lanes: int, trials: int = 0, words: int = 0,
               k_planes: int = 0, draws: int = 0, tails: int = 0,
               coins: int = 0, sizes: int = 0) -> int:
    """Operations the function needs on this run's inputs: ``lanes`` lanes
    (for the dense tally: edges) in ``words`` plane words with ``k_planes``
    k planes, ``trials`` trials; for the round kernels ``draws`` lanes
    drawing a CF pair (two quantiles each, ``tails`` of them in the tail)
    and ``coins`` lanes drawing a coin; for cf_counts and equiv_counts
    ``tails`` of the lanes' 2 or 4 quantiles in the tail; ``sizes``
    distinct (trial, sample size) pairs of the draws whose sample size is
    the lane's own."""
    prop = OPS_READ_PLANES + 15
    vote = OPS_READ_PLANES + 4 + 31
    if kernel in ("proposal_hist", "vote_commit", "fused_round"):
        base = {"proposal_hist": prop, "vote_commit": vote,
                "fused_round": prop + vote}[kernel]
        k_ops = 0 if kernel == "proposal_hist" else words * 2 * k_planes
        n_phases = 2 if kernel == "fused_round" else 1
        return (lanes * base + k_ops + draws * OPS_CF_PAIR_LANE
                + sizes * OPS_CF_TERMS + ops_quantiles(2 * draws, tails)
                + coins * (OPS_THREEFRY + 1)
                + n_phases * trials * OPS_CF_TRIAL)
    return {
        # the pair, hq = max(m - h0 - h1, 0), three casts
        "cf_counts": lanes * (OPS_CF_PAIR_LANE + 6) + sizes * OPS_CF_TERMS
        + ops_quantiles(2 * lanes, tails) + trials * OPS_CF_TRIAL,
        # one block, the bit, the cast
        "coin_flips": lanes * (OPS_THREEFRY + 2),
        # one block, the bit, the deviation uniform, compare and select
        "weak_coin_flips": lanes * (OPS_THREEFRY + 2 + OPS_UNIFORM + 2),
        # two blocks, four uniforms, the samples of h_b, h0 and h1, the
        # binomial split's ~8 ops and its quantile, ~8 sums and clamps;
        # four quantiles; the terms of h0's and h1's sample sizes; the
        # trial terms of h_b and of h0's and h1's populations
        "equiv_counts": lanes * (2 * OPS_THREEFRY + 4 * OPS_UNIFORM
                                 + 3 * OPS_CF_SAMPLE + 16)
        + sizes * OPS_CF_TERMS + ops_quantiles(4 * lanes, tails)
        + trials * 80,
        "dense_counts": 3 * lanes,
    }[kernel]


def ops_per_lane_whole(kernel: str, planes: int = 0) -> int:
    """The whole-draw count of one lane's operations, printed beside
    ``ops_needed``: every lane charged every draw whole (its trial's terms
    and the far tail of the normal quantile included) and the coin."""
    threefry, uniform, ndtri = 117, 5, 53
    draw = 50 + ndtri
    pair = threefry + 2 * uniform + 2 * draw + 6
    prop = 2 * planes + pair + 15
    vote = 2 * planes + pair + threefry + 31 + 2 * planes
    return {
        "proposal_hist": prop, "vote_commit": vote,
        "fused_round": prop + vote, "cf_counts": pair + 6,
        "coin_flips": threefry + 2,
        "weak_coin_flips": threefry + 2 + uniform + 2,
        "equiv_counts": 2 * threefry + 4 * uniform + 3 * draw + ndtri + 20,
        "dense_counts": 3,
    }[kernel]


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def smi(query: str) -> str:
    """One nvidia-smi reading of the first card, without units."""
    return sh(["nvidia-smi", f"--query-gpu={query}",
               "--format=csv,noheader,nounits"]).splitlines()[0]


def clock_during(fn, seconds: float = 1.0) -> float:
    """Run ``fn`` over and over for about ``seconds`` on the card while
    nvidia-smi reads ``clocks.sm`` half-way -> the reading in MHz (NaN if
    nvidia-smi gave none)."""
    import threading

    import torch
    seen = {}

    def read():
        try:
            seen["mhz"] = float(smi("clocks.sm"))
        except (OSError, ValueError, subprocess.CalledProcessError) as e:
            print(f"[clock] nvidia-smi: {e!r}", file=sys.stderr)

    reader = threading.Thread(target=read, daemon=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or reader.is_alive():
        if not reader.ident and time.perf_counter() - t0 > seconds / 2:
            reader.start()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 20 * seconds:
            break
    if reader.ident:
        reader.join(timeout=30)
    return seen.get("mhz", float("nan"))


def cuda_ms(fn, n: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after 3 warm-up calls.
    A call of a few microseconds can be held to the host's pace of
    launching; ``queued``: the card first sleeps for LEAD_CYCLES, so the
    host has queued the ``n`` calls before the first runs, and the time is
    the device's alone."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def random_pack(cfg, device, seed, balanced=False):
    """A plane stack of a random mid-run state (x, decided, killed, k,
    faulty drawn on the device; with ``balanced`` x alternates 0 and 1
    over the nodes and nodes 2j and 2j + 1 share every other field, so
    that the live and the frozen lanes hold as many 0s as 1s and the
    rounds' tallies tie) -> (pack, its proposal histogram)."""
    import torch
    from benor_tpu_torch.ops.packed_round import (pack_state,
                                                  sent_hist_from_pack)
    from benor_tpu_torch.state import NetState

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.trials, cfg.n_nodes)

    def draw(hi):
        return torch.randint(0, hi, shape, generator=g, device=device)

    x, dec, k = draw(3), draw(10) == 0, draw(cfg.max_rounds + 2)
    killed, faulty = draw(10) == 0, draw(10) == 0
    if balanced:
        node = torch.arange(cfg.n_nodes, device=device)
        x = (node % 2).expand(shape)
        dec, k, killed, faulty = (a[:, node // 2 * 2]
                                  for a in (dec, k, killed, faulty))
    state = NetState(x=x.to(torch.int8), decided=dec,
                     k=k.to(torch.int32), killed=killed)
    pack = pack_state(cfg, state, faulty)
    return pack, sent_hist_from_pack(cfg, pack)


def repeats(fn, n: int = 3, queued: bool = False) -> list[float]:
    """``n`` repeats of ``cuda_ms(fn, TIMED_LAUNCHES, queued)``."""
    return [cuda_ms(fn, TIMED_LAUNCHES, queued) for _ in range(n)]


def median(xs):
    return sorted(xs)[len(xs) // 2]


def tail_quantiles(key, need) -> int:
    """Of the two uniforms of each lane's threefry block under ``key``, how
    many take the normal quantile's middle-tail branch (|u - 0.5| > 0.425
    in f32, as ndtri_clipped tests it), over the lanes where the bool
    [T, N] ``need`` holds."""
    from benor_tpu_torch.ops.stream import (bits_to_uniform, lane_ids,
                                            threefry2x32)
    node, trial = lane_ids(need.shape[0], need.shape[1], need.device)
    tails = 0
    for bits in threefry2x32(key[0], key[1], node, trial):
        tails += int((((bits_to_uniform(bits) - 0.5).abs() > 0.425)
                      & need).sum())
    return tails


def distinct_sizes(sizes, need=None) -> int:
    """Distinct (trial, value) pairs of a [T, N] tensor of sample sizes
    (>= 0), over the lanes where the bool ``need`` holds."""
    import torch
    if need is not None:
        sizes = torch.where(need, sizes, -1.0)
    s = sizes.sort(dim=1).values
    new = s >= 0
    new[:, 1:] &= s[:, 1:] != s[:, :-1]
    return int(new.sum())


def pair_sizes(key, hist, m, shape, device):
    """The second draw's sample sizes max(m - p0, 0) of the CF pairs
    (stream.cuh cf_pair) under ``key`` against the int [T, 3] ``hist`` ->
    (sizes f32 [T, N] for the lanes' ``shape``, the window centre the
    counts kernel tabulates around, [T, 1])."""
    import torch
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import (bits_to_uniform, cf_pop,
                                            cf_sample, cf_terms, lane_ids,
                                            threefry2x32)
    node, trial = lane_ids(shape[0], shape[1], device)
    b0, _ = threefry2x32(key[0], key[1], node, trial)
    h = count_vecs(hist)
    mf = torch.full_like(h[:, 0:1], float(m))
    d1 = cf_terms(cf_pop(h[:, 0:1] + h[:, 1:2] + h[:, 2:3], h[:, 0:1]), mf)
    p0 = cf_sample(bits_to_uniform(b0), d1)
    return (torch.clamp_min(mf - p0, 0.0),
            torch.clamp_min(mf - centre_draw(d1), 0.0))


def equiv_sizes(hist, n_equiv, m, n_nodes, phase=None):
    """The sample sizes of the h0 and h1 draws of the equivocate tally
    (stream.cuh equiv_draws) under ``phase``'s streams of ROUND (default
    the vote phase, as equiv_counts draws) -> ((rem, its window centre),
    (max(rem - h0, 0), its window centre)), [T, N] and [T, 1] f32."""
    import torch
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import (_EQUIV_SALT_OFFSET,
                                            bits_to_uniform, cf_sample,
                                            cf_terms, equiv_trial, lane_ids,
                                            stream_scal, threefry2x32)
    node, trial = lane_ids(hist.shape[0], n_nodes, hist.device)
    phase = rng.PHASE_VOTE if phase is None else phase
    k, k2 = (stream_scal(SEED, ROUND, s) for s in (
        phase, phase + _EQUIV_SALT_OFFSET))
    b0, _ = threefry2x32(k[0], k[1], node, trial)
    b2, _ = threefry2x32(k2[0], k2[1], node, trial)
    e = equiv_trial(count_vecs(hist), count_vecs(n_equiv), m)
    rem = torch.clamp_min(e["m"] - cf_sample(bits_to_uniform(b2), e["db"]),
                          0.0)
    h0 = cf_sample(bits_to_uniform(b0), cf_terms(e["pop0"], rem))
    c_rem = torch.clamp_min(e["m"] - centre_draw(e["db"]), 0.0)
    c_rest = torch.clamp_min(
        c_rem - centre_draw(cf_terms(e["pop0"], c_rem)), 0.0)
    return (rem, c_rem), (torch.clamp_min(rem - h0, 0.0), c_rest)


def centre_draw(d):
    """A draw's value at z = 0, clamped to its support (stream.cuh
    centre_draw), from its terms (ops/stream.py cf_terms)."""
    import torch
    return torch.minimum(torch.maximum(torch.round(d["mean"]), d["lo"]),
                         d["hi"])


def outside_window(sizes, center, window) -> int:
    """Lanes whose sample size falls outside the ``window`` sizes a counts
    kernel's block tabulates around ``center`` (stream.cuh fill_table):
    they compute their terms."""
    import torch
    off = sizes - (torch.round(center) - window // 2)
    return int(((off < 0) | (off >= window)).sum())


def lane_needs(pack, keys, m, hists, freeze=True, qok=None,
               new_pack=None) -> dict:
    """Lanes of a plane stack whose draws a round kernel's function reads:
    the proposal's CF pair where a lane is alive and not frozen, the vote's
    where it is also in a trial whose quorum is met, the coin where the
    vote's new stack has the coined bit -> counts of those lanes, of their
    quantiles that take the tail and of the distinct (trial, sample size)
    of their second draws (``keys``: the proposal's and the vote's stream
    keys; ``hists``: the two phases' histograms; ``m``: the quorum)."""
    from benor_tpu_torch.ops.packed_round import plane_field
    from benor_tpu_torch.state import PACK_COINED, PACK_DECIDED, PACK_KILLED
    live = plane_field(pack, PACK_KILLED, 1) == 0
    if freeze:
        live &= plane_field(pack, PACK_DECIDED, 1) == 0
    out = {"proposal_draws": int(live.sum()),
           "proposal_tails": tail_quantiles(keys[0], live),
           "proposal_sizes": distinct_sizes(pair_sizes(
               keys[0], hists[0], m, live.shape, live.device)[0], live)}
    if qok is not None:
        vneed = live & qok.bool()[:, None]
        out["vote_draws"] = int(vneed.sum())
        out["vote_tails"] = tail_quantiles(keys[1], vneed)
        out["vote_sizes"] = distinct_sizes(pair_sizes(
            keys[1], hists[1], m, vneed.shape, vneed.device)[0], vneed)
    if new_pack is not None:
        out["coins"] = int(plane_field(new_pack, PACK_COINED, 1).sum())
    return out


def main_cfg():
    """The main path's configuration at N = 1M x 32 that the kernel fixtures
    are drawn for."""
    from benor_tpu_torch import SimConfig
    return SimConfig(n_nodes=N_MAIN, n_faulty=N_MAIN // 4, trials=TRIALS,
                     max_rounds=MAX_ROUNDS)


# the scenarios of tests/test_scenarios.py (the reference's integration-test
# contract, benorconsensus.test.ts:45-492) and the upstream default launch:
# (name, faulty list, initial values, SimConfig overrides)
SCENARIOS = (
    ("status_2_healthy_1_faulty", [True, False, False], [1, 1, 1], {}),
    ("status_8_healthy_2_faulty",
     [True, False, False, False, False, True, False, False, False, False],
     [1] * 10, {}),
    ("unanimous_agreement", [False] * 5, [1] * 5, {}),
    ("simple_majority", [False, False, False, False, True], [1, 1, 1, 0, 0],
     {}),
    ("fault_tolerance_threshold", [True] * 4 + [False] * 5,
     [0, 0, 1, 1, 1, 0, 0, 1, 1], {}),
    ("exceeding_fault_tolerance_livelock", [True] * 5 + [False] * 5,
     [0, 0, 1, 1, 1, 0, 0, 1, 1, 0], {"max_rounds": 15}),
    ("no_faulty_nodes", [False] * 5, [0, 1, 0, 1, 1], {}),
    ("randomized", [False, False, True, False, True, False, False],
     None, {}),                  # values: default_rng(42), as the test draws
    ("one_node", [False], [1], {}),
    ("stop_consensus_kills_all", [False] * 3, [1, 1, 1], {}),
    ("default_config", [True] * 4 + [False] * 6,
     [0, 0, 1, 1, 1, 0, 0, 1, 1, 1], {}),
)
N_ALL_CPU = 65_536        # the 'all' path's card-vs-CPU run at scale
N_ALL_SMALL = 8192        # ... and its equivocate card-vs-CPU runs (x 8)
F_EQUIV_TABLE = 4096      # the largest F the exact shared table serves
F_EQUIV_QUANTILE = 200_000


def api_phase() -> None:
    """The facade on the card: each scenario launched, started and read
    through ``launch_network`` / ``start_consensus`` / ``get_nodes_state``,
    held state for state against the same launch on the CPU; the livelock
    scenario again with ``poll_rounds=1`` against its one-shot run."""
    import numpy as np
    from benor_tpu_torch import launch_network
    from benor_tpu_torch.api import (get_nodes_state, reached_finality,
                                     start_consensus, stop_consensus)

    def run(faulty, values, device, **kw):
        net = launch_network(len(faulty), sum(faulty), values, faulty,
                             device=device, **kw)
        start_consensus(net)
        return net

    for name, faulty, values, kw in SCENARIOS:
        if values is None:
            values = [int(v) for v in
                      np.random.default_rng(42).integers(0, 2, size=7)]
        nets = {d: run(faulty, values, d, **kw) for d in ("cuda", "cpu")}
        if name.startswith("stop"):
            for net in nets.values():
                stop_consensus(net)
        states = {d: get_nodes_state(net) for d, net in nets.items()}
        same = (states["cuda"] == states["cpu"]
                and nets["cuda"].rounds_executed
                == nets["cpu"].rounds_executed
                and trials_differing(nets["cuda"].state,
                                     nets["cpu"].state) == 0)
        live = [st for st, f in zip(states["cuda"], faulty) if not f]
        if "livelock" in name:
            verdict = not any(st["decided"] for st in live)
        elif name.startswith("stop"):
            verdict = all(st["killed"] for st in live)
        else:
            verdict = (reached_finality(states["cuda"])
                       and len({st["x"] for st in live}) == 1)
        print(f"[api] {name}: N={len(faulty)} F={sum(faulty)} rounds "
              f"{nets['cuda'].rounds_executed}, card == cpu {same}, "
              f"verdict held {verdict}")
        if not (same and verdict):
            raise SystemExit(f"[api] {name}: failed")
    name, faulty, values, kw = next(sc for sc in SCENARIOS
                                    if "livelock" in sc[0])
    one = run(faulty, values, "cuda", **kw)
    slices = []
    polled = launch_network(len(faulty), sum(faulty), values, faulty,
                            poll_rounds=1, **kw)
    polled.start(on_slice=lambda: slices.append(polled.get_state(9)["k"]))
    same = (get_nodes_state(polled) == get_nodes_state(one)
            and polled.rounds_executed == one.rounds_executed
            and trials_differing(polled.state, one.state) == 0)
    print(f"[api] {name} poll_rounds=1: {len(slices)} slices, k seen "
          f"{slices[0]}..{slices[-1]}, equal to one-shot {same}")
    if not same or len(slices) != one.rounds_executed:
        raise SystemExit("[api] poll_rounds run differs from one-shot")


def split_compare(dev) -> None:
    """The equivocator split on the card against the same call on the CPU,
    on one round's uniforms at N = 1M x 4: the normal quantile
    (differing values and their largest ulp distance), the quantile's
    draws at F_EQUIV_QUANTILE and the exact table's at F_EQUIV_TABLE."""
    import torch
    from benor_tpu_torch.ops import rng, sampling
    tid, nid = rng.ids(4, device=dev), rng.ids(N_MAIN, device=dev)
    u = rng.grid_uniforms(SEED, 1, rng.PHASE_PROPOSAL + 32, tid, nid)
    u_cpu = u.cpu()
    p = torch.clamp(u, 1e-7, 1 - 1e-7)
    z, z_cpu = sampling.ndtri(p).cpu(), sampling.ndtri(p.cpu())
    ulps = (z.view(torch.int32).to(torch.int64)
            - z_cpu.view(torch.int32).to(torch.int64)).abs()
    n_q = torch.full((4, 1), F_EQUIV_QUANTILE, dtype=torch.int32)
    n_t = torch.full((4,), F_EQUIV_TABLE, dtype=torch.int32)
    d_q = int((sampling.binomial_half(u, n_q.to(dev)).cpu()
               != sampling.binomial_half(u_cpu, n_q)).sum())
    d_t = int((sampling.binomial_half_exact_shared(
        u, n_t.to(dev), F_EQUIV_TABLE).cpu()
        != sampling.binomial_half_exact_shared(u_cpu, n_t,
                                               F_EQUIV_TABLE)).sum())
    print(f"[all] split card vs cpu over {u.numel()} uniforms: ndtri "
          f"differing {int((ulps > 0).sum())} (max {int(ulps.max())} ulp); "
          f"binomial_half draws at n={F_EQUIV_QUANTILE} differing {d_q}; "
          f"exact table draws at n={F_EQUIV_TABLE} differing {d_t}")
    if d_t:
        raise SystemExit("the exact table's draws differ card vs cpu")


def round_pair(tag, lib, cfg, pack, hist1, hist2=None, qok=None) -> dict:
    """proposal_hist and vote_commit against their plain versions on one
    fixture (the vote on the proposal's own histogram and gate unless
    given), then three timed repeats of each -> dict: res (each kernel's
    compare result), ms (its repeats), needs (lane_needs), calls (the two
    launches), plain (the two plain versions, untimed), lanes."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal

    m, r = cfg.quorum, ROUND
    t, _, n_w = pack.shape
    lanes = t * n_w * 32
    keys = [stream_scal(SEED, r, s) for s in (rng.PHASE_PROPOSAL,
                                              rng.PHASE_VOTE, _COIN_SALT)]
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="reference", **MODES)
    parts_k = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist1, pack, m,
                               **MODES)
    parts_p = pr.proposal_hist_plain(SEED, r, rng.PHASE_PROPOSAL, hist1,
                                     pack, m, **MODES)
    torch.cuda.synchronize()
    res_p = compare(f"proposal_hist {tag}", lanes, [(parts_k, parts_p)])
    hist2 = parts_p[:, :3] if hist2 is None else hist2
    qok = parts_p[:, 3] >= m if qok is None else qok
    new_k, vparts_k = pr.vote_commit(SEED, r, rng.PHASE_VOTE, hist2, pack,
                                     qok, **vote)
    new_p, vparts_p = pr.vote_commit_plain(SEED, r, rng.PHASE_VOTE, hist2,
                                           pack, qok, **vote)
    torch.cuda.synchronize()
    res_v = compare(f"vote_commit {tag}", lanes, [(new_k, new_p),
                                                  (vparts_k, vparts_p)])
    needs = lane_needs(pack, keys, m, (hist1, hist2), MODES["freeze"], qok,
                       new_p)
    del new_k, new_p
    hist_f, hist2_f = count_vecs(hist1), count_vecs(hist2)
    qok_i = qok.to(torch.int32).contiguous()
    calls = {
        "proposal_hist": lambda: pr._launch_proposal_hist(
            lib, keys[0], hist_f, pack, m, **MODES),
        "vote_commit": lambda: pr._launch_vote_commit(
            lib, keys[1], keys[2], r + 1, hist2_f, qok_i, pack, m,
            cfg.n_faulty, "reference", "crash", True),
    }
    ms = {k: repeats(fn) for k, fn in calls.items()}
    print(f"[fixture] {tag}: lanes {lanes}, needs {needs}; kernel ms {ms}")
    return dict(res=(res_p, res_v), ms=ms, needs=needs, calls=calls,
                lanes=lanes,
                plain=(lambda: pr.proposal_hist_plain(
                    SEED, r, rng.PHASE_PROPOSAL, hist1, pack, m, **MODES),
                    lambda: pr.vote_commit_plain(
                    SEED, r, rng.PHASE_VOTE, hist2, pack, qok, **vote)))


def fused_shape(lib, trials, n, device) -> dict:
    """fused_round on a random_pack fixture of ``trials`` x ``n`` against
    its plain version and against the two-kernel route (proposal_hist, the
    node-axis sum and the quorum gate, vote_commit: packed_round's other
    branch), bit for bit, then three timed repeats each of the kernel's
    launch alone, of the fused wrapper and of the two-kernel route, each
    timed as every kernel is and queued (``cuda_ms``) -> dict: res (the
    kernel's compare result), ms (the repeats by name, the queued ones
    under "<name>_queued"), cfg, pack, hist, out (the plain version's
    outputs), kernel (the launch), lanes, n_w."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal

    cfg = main_cfg().replace(n_nodes=n, n_faulty=n // 4, trials=trials)
    m, r = cfg.quorum, ROUND
    pack, hist = random_pack(cfg, device, SEED + 1)
    lanes = trials * pack.shape[2] * 32
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="reference", **MODES)

    def fused():
        return pr.fused_round(SEED, r, hist, pack, **vote)

    def two_kernel():
        parts_a = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist, pack, m,
                                   **MODES)
        new_pack, parts_b = pr.vote_commit(SEED, r, rng.PHASE_VOTE,
                                           parts_a[:, :3], pack,
                                           parts_a[:, 3] >= m, **vote)
        return new_pack, parts_a, parts_b

    out_k = fused()
    out_p = pr.fused_round_plain(SEED, r, hist, pack, **vote)
    out_2 = two_kernel()
    torch.cuda.synchronize()
    tag = f"T={trials} N={n}"
    res = compare(f"fused_round {tag}", lanes, list(zip(out_k, out_p)))
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_2))
    print(f"[dispatch] fused_round vs proposal_hist + sum + vote_commit at "
          f"{tag}: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"fused and two-kernel rounds differ at {tag}")
    keys = [stream_scal(SEED, r, s) for s in (rng.PHASE_PROPOSAL,
                                              rng.PHASE_VOTE, _COIN_SALT)]
    hist_f = count_vecs(hist)

    # trees from before the cluster kernel (round_stats.py --base) take
    # no grid
    grid = ((pr.fused_grid(lib, pack.shape[2], trials, device),)
            if hasattr(pr, "fused_grid") else ())

    def kernel():
        return pr._launch_fused_round(lib, *keys, r + 1, hist_f, pack, m,
                                      cfg.n_faulty, "reference", "crash",
                                      True, *grid)

    ms = {}
    for name, fn in (("kernel", kernel), ("fused", fused),
                     ("two_kernel", two_kernel)):
        ms[name] = repeats(fn)
        ms[f"{name}_queued"] = repeats(fn, queued=True)
    return dict(res=res, ms=ms, cfg=cfg, pack=pack, hist=hist, out=out_p,
                kernel=kernel, lanes=lanes, n_w=pack.shape[2])


def fused_family(lib, device) -> dict:
    """fused_shape at every shape of FUSED_FAMILY -> {(T, N): its dict},
    each shape's times printed on a [time] line, timed as every kernel is
    and queued (the device's time alone)."""
    out = {}
    for t, n in FUSED_FAMILY:
        f = out[(t, n)] = fused_shape(lib, t, n, device)
        ms = {k: median(v) for k, v in f["ms"].items()}
        line = []
        for how, sfx in (("timed", ""), ("queued", "_queued")):
            k, w, r = (ms[f"kernel{sfx}"], ms[f"fused{sfx}"],
                       ms[f"two_kernel{sfx}"])
            line.append(f"{how}: kernel {f['ms']['kernel' + sfx]} ms "
                        f"(median {k:.4f}), fused wrapper {w:.4f} ms beside "
                        f"the two-kernel route {r:.4f} ms ({w / r:.3f}x)")
        print(f"[time] fused_round T={t} N={n} (route: proposal_hist + sum "
              f"+ vote_commit): " + "; ".join(line))
    return out


def fused_run_cases(base: dict, device) -> list:
    """The packed main path's runs that take the fused kernel: its cap
    N = 8192 at 32 trials and at one, balanced inputs, f = 0.25, no
    crashes, the other settings ``base`` -> [(name, cfg, inputs,
    faults)]."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs

    out = []
    for t in (TRIALS, 1):
        c = SimConfig(n_nodes=N_FUSED, n_faulty=N_FUSED // 4,
                      **{**base, "trials": t})
        out.append((f"balanced_f0.25_n{N_FUSED}_t{t}", c,
                    balanced_inputs(t, N_FUSED),
                    FaultSpec.none(t, N_FUSED, device=device)))
    return out


def edge_hists(n: int, m: int, trials: int, device):
    """One edge histogram (c0, c1, "?") a trial, cycling: total 0 and 1,
    c0 = 0, c0 = total, all "?", the quorum above the total, c0 near the
    total (so m - p0 <= 0 in many lanes), balanced, a ragged mix."""
    cases = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, n // 2, n // 2), (n, 0, 0),
             (0, 0, n), (m // 4, m // 4, m // 8), (n - 10, 5, 5),
             (n // 2, n // 2, 0), (n // 3, n // 2, n - n // 3 - n // 2)]
    import torch
    return torch.tensor([cases[i % len(cases)] for i in range(trials)],
                        dtype=torch.int32, device=device)


def inactive_pack(cfg, device, seed):
    """A plane stack with whole warps inactive: per trial the first F nodes
    killed (FaultSpec.first_f's layout) and a run of N/64 more, a run of
    decided (frozen) lanes over a quarter of the nodes, the rest random as
    in random_pack -> (pack, its proposal histogram)."""
    import torch
    from benor_tpu_torch.ops.packed_round import (pack_state,
                                                  sent_hist_from_pack)
    from benor_tpu_torch.state import NetState

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.trials, cfg.n_nodes)

    def draw(hi):
        return torch.randint(0, hi, shape, generator=g, device=device)

    node = torch.arange(cfg.n_nodes, device=device)[None, :]
    n = cfg.n_nodes
    run = (node >= n // 2) & (node < n // 2 + n // 64)
    frozen = (node >= n // 4) & (node < n // 2)
    killed = ((draw(10) == 0) | (node < cfg.n_faulty) | run) & ~frozen
    state = NetState(x=draw(3).to(torch.int8),
                     decided=(draw(10) == 0) | frozen,
                     k=draw(cfg.max_rounds + 2).to(torch.int32),
                     killed=killed)
    pack = pack_state(cfg, state, draw(10) == 0)
    return pack, sent_hist_from_pack(cfg, pack)


def cf_fixtures(device) -> dict:
    """cf_counts' fixtures -> {tag: (hist int32 [T, 3], m, N)}: the unfused
    path's round-1 operands at balanced f = 0.40, one edge histogram a
    trial (edge_hists) at the same quorum, and a ragged N = 1,000,003 x 7
    with multinomial histograms from the seed."""
    import numpy as np
    import torch
    m = N_MAIN - int(0.40 * N_MAIN)
    bal = torch.tensor([[N_MAIN // 2, N_MAIN // 2, 0]] * TRIALS,
                       dtype=torch.int32, device=device)
    ragged = np.random.default_rng(SEED).multinomial(
        N_RAGGED, [0.45, 0.45, 0.1], size=T_RAGGED)
    return {"balanced": (bal, m, N_MAIN),
            "edge-histograms": (edge_hists(N_MAIN, m, TRIALS, device), m,
                                N_MAIN),
            "ragged": (torch.tensor(ragged, dtype=torch.int32, device=device),
                       N_RAGGED - int(0.40 * N_RAGGED), N_RAGGED)}


def equiv_fixtures(device) -> dict:
    """equiv_counts' fixtures -> {tag: (honest hist int32 [T, 3], n_equiv
    int32 [T], m, N)}: equiv_uniform_f0.20's round-1 operands (balanced
    inputs, the first F lanes equivocating, all alive), one edge histogram
    a trial with n_equiv cycling over 0, the trial's total and F, and a
    ragged N = 1,000,003 x 7 with F = N / 5 (a few equivocators not
    live)."""
    import numpy as np
    import torch
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.ops import tally
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs

    ecfg = SimConfig(n_nodes=N_MAIN, n_faulty=int(0.2 * N_MAIN),
                     trials=TRIALS, fault_model="equivocate")
    faults = FaultSpec.first_f(ecfg, device=device)
    st = init_state(ecfg, balanced_inputs(TRIALS, N_MAIN), faults)
    alive = ~st.killed
    hist = tally.class_histogram(st.x, alive & ~faults.faulty)
    n_equiv = (faults.faulty & alive).sum(-1, dtype=torch.int32)
    print(f"[operands] equiv_uniform_f0.20 round 1: hist {hist[0].tolist()}"
          f" n_equiv {int(n_equiv[0])} m {ecfg.quorum}")
    edge = edge_hists(N_MAIN, ecfg.quorum, TRIALS, device)
    cycle = torch.stack([torch.zeros_like(edge[:, 0]),
                         edge.sum(1, dtype=torch.int32),
                         torch.full_like(edge[:, 0], ecfg.n_faulty)], 1)
    edge_ne = cycle[torch.arange(TRIALS, device=device),
                    torch.arange(TRIALS, device=device) % 3]
    f_r = N_RAGGED // 5
    ragged = np.random.default_rng(SEED + 1).multinomial(
        N_RAGGED - f_r, [0.45, 0.45, 0.1], size=T_RAGGED)
    return {"balanced": (hist, n_equiv, ecfg.quorum, N_MAIN),
            "edge-histograms": (edge, edge_ne.contiguous(), ecfg.quorum,
                                N_MAIN),
            "ragged": (torch.tensor(ragged, dtype=torch.int32, device=device),
                       f_r - torch.arange(T_RAGGED, dtype=torch.int32,
                                          device=device),
                       N_RAGGED - f_r, N_RAGGED)}


def hist_pair(tag, lib, cf, eq) -> dict:
    """cf_counts and equiv_counts against their plain versions on one
    fixture (``cf``: hist, m, N; ``eq``: hist, n_equiv, m, N; the proposal
    and the vote stream of ROUND), then three timed repeats of each ->
    dict: res (each kernel's compare result), ms (its repeats), calls (the
    two launches), plain (the two plain versions, untimed)."""
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.launch import count_vecs
    from benor_tpu_torch.ops.stream import _EQUIV_SALT_OFFSET, stream_scal

    (hist, m, n), (ehist, ne, em, en) = cf, eq
    args = (SEED, ROUND, rng.PHASE_PROPOSAL, hist, m, n)
    eargs = (SEED, ROUND, rng.PHASE_VOTE, ehist, ne, em, en)
    res_c = compare(f"cf_counts {tag}", hist.shape[0] * n,
                    [(hk.cf_counts(*args), hk.cf_counts_plain(*args))])
    res_e = compare(f"equiv_counts {tag}", ehist.shape[0] * en,
                    [(hk.equiv_counts(*eargs), hk.equiv_counts_plain(*eargs))])
    pkey, vkey, ekey2 = (stream_scal(SEED, ROUND, s) for s in (
        rng.PHASE_PROPOSAL, rng.PHASE_VOTE,
        rng.PHASE_VOTE + _EQUIV_SALT_OFFSET))
    hist_f, ehist_f, ne_f = count_vecs(hist), count_vecs(ehist), count_vecs(ne)
    calls = {
        "cf_counts": lambda: hk._launch_cf_counts(lib, pkey, hist_f, m, n),
        "equiv_counts": lambda: hk._launch_equiv_counts(
            lib, vkey, ekey2, ehist_f, ne_f, em, en),
    }
    ms = {k: repeats(fn) for k, fn in calls.items()}
    print(f"[fixture] {tag}: cf_counts {hist.shape[0]} x {n} m {m}, "
          f"equiv_counts {ehist.shape[0]} x {en} m {em}; kernel ms {ms}")
    return dict(res=(res_c, res_e), ms=ms, calls=calls,
                plain=(lambda: hk.cf_counts_plain(*args),
                       lambda: hk.equiv_counts_plain(*eargs)))


def coin_shared(trials, device):
    """The weak coin's shared operand: ROUND's common coin, one bit a trial
    (int8 [T])."""
    from benor_tpu_torch.ops import rng
    return rng.coin_flips(SEED, ROUND, rng.ids(trials, device=device),
                          rng.ids(1, device=device), common=True)[:, 0]


def coin_exact(tag, trials, n, device) -> dict:
    """coin_flips, and weak_coin_flips at each of COIN_EPS, against their
    plain versions on ``trials`` x ``n`` lanes under ROUND's coin stream ->
    {kernel: compare result} (the weak coin's at eps = 0.5)."""
    from benor_tpu_torch.ops import hist as hk
    res = {"coin_flips": compare(
        f"coin_flips {tag}", trials * n,
        [(hk.coin_flips(SEED, ROUND, trials, n, device),
          hk.coin_flips_plain(SEED, ROUND, trials, n, device))])}
    shared = coin_shared(trials, device)
    for eps in COIN_EPS:
        args = (SEED, ROUND, trials, n, eps, shared)
        r = compare(f"weak_coin_flips {tag} eps={eps}", trials * n,
                    [(hk.weak_coin_flips(*args),
                      hk.weak_coin_flips_plain(*args))])
        if eps == 0.5:
            res["weak_coin_flips"] = r
    return res


def coin_pair(tag, lib, trials, n, device) -> dict:
    """The coin kernels against their plain versions (coin_exact), then
    three timed repeats of each launch (the weak coin at eps = 0.5) ->
    dict: res (each kernel's compare result), ms (its repeats), calls (the
    two launches), plain (the two plain versions, untimed)."""
    import torch
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal

    res = coin_exact(tag, trials, n, device)
    key = stream_scal(SEED, ROUND, _COIN_SALT)
    shared = coin_shared(trials, device)
    shared_i = shared.to(torch.int32).contiguous()
    calls = {
        "coin_flips": lambda: hk._launch_coin_flips(lib, key, trials, n,
                                                    device),
        "weak_coin_flips": lambda: hk._launch_weak_coin_flips(
            lib, key, trials, n, 0.5, shared_i),
    }
    ms = {k: repeats(fn) for k, fn in calls.items()}
    print(f"[fixture] {tag}: coins {trials} x {n}; kernel ms {ms}")
    return dict(res=res, ms=ms, calls=calls, plain=(
        lambda: hk.coin_flips_plain(SEED, ROUND, trials, n, device),
        lambda: hk.weak_coin_flips_plain(SEED, ROUND, trials, n, 0.5,
                                         shared)))


def coin_grid(lib, shapes, device) -> str:
    """The coin kernels' grid at each (T, N) of ``shapes``: blocks a trial
    B of each kernel, the nodes a thread takes a pass K and the grid's
    blocks T x B."""
    from benor_tpu_torch.ops import hist as hk
    parts = []
    for t, n in shapes:
        b = [hk.hist_blocks(lib, k, n, t, device) for k in (2, 3)]
        parts.append(f"T={t} N={n}: B {b[0]} / {b[1]}, blocks {t * b[0]} / "
                     f"{t * b[1]}")
    return (f"coin_flips / weak_coin_flips, K {hk.COIN_NODES} nodes a "
            f"thread: " + "; ".join(parts))


def dense_case(t, n_recv, n_send, device):
    """The dense tally's operands, bench.py's fixture made with numpy from
    the seed: mask Bernoulli 0.8 [t, n_recv, n_send], sent uniform in
    {0, 1, 2} and alive Bernoulli 0.9 [t, n_send]."""
    import numpy as np
    import torch
    rs = np.random.default_rng(SEED)
    mask = rs.random((t, n_recv, n_send), dtype=np.float32) < 0.8
    sent = rs.integers(0, 3, (t, n_send)).astype(np.int8)
    alive = rs.random((t, n_send)) < 0.9
    return [torch.from_numpy(a).to(device) for a in (mask, sent, alive)]


def table_sizes(tag, cf, eq) -> dict:
    """The per-lane sample sizes of cf_counts and equiv_counts on one
    fixture (``cf``, ``eq`` as hist_pair takes them) -> {kernel: distinct
    (trial, sample size) pairs}, printed with the lanes that fall outside
    the blocks' tables and so compute their terms."""
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.stream import stream_scal
    cfh, m, n = cf
    sizes, center = pair_sizes(stream_scal(SEED, ROUND, rng.PHASE_PROPOSAL),
                               cfh, m, (cfh.shape[0], n), cfh.device)
    eq = equiv_sizes(*eq)
    n_sizes = {"cf_counts": distinct_sizes(sizes),
               "equiv_counts": sum(distinct_sizes(x) for x, _ in eq)}
    outside = {"cf_counts": outside_window(sizes, center, CF_WINDOW),
               "equiv_counts": [outside_window(x, c, EQUIV_WINDOW)
                                for x, c in eq]}
    print(f"[tables] {tag}: distinct (trial, sample size) {n_sizes}; lanes "
          f"outside the tables' windows {outside} (they compute their "
          f"terms)")
    return n_sizes


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


def breakdown(tag, name, run, t_run, ours, torch_ops=False):
    """Profile one call of ``run`` -> a ``[breakdown]`` line: device busy
    time, the share of the named kernels, and the top device entries;
    with ``torch_ops``, also the torch ops whose kernels took the most
    device time (a path of plain torch, where the kernels' names say
    little)."""
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
    # a port kernel's entry: its name, its template arguments if any
    port = re.compile(r"(\w+_kernel)(<[^>]*>)?\(")

    def ours_(e):
        m = port.search(e.key)
        return m if m and any(k in m.group(1) for k in ours) else None

    ours_ms = sum(dev_us(e) for e in evs if ours_(e)) / 1e3
    per = ", ".join(f"{''.join(g for g in ours_(e).groups() if g)} "
                    f"{dev_us(e) / e.count / 1e3:.4f} ms a launch x{e.count}"
                    for e in evs if ours_(e))
    if torch_ops:
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.key.startswith("aten::") and dev_us(e) > 0),
                     key=dev_us, reverse=True)
        top += "; top torch ops by their kernels' device time: " + ", ".join(
            f"{e.key} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in ops[:10])
    print(f"[breakdown] {tag} {name}: profiled run_consensus: device busy "
          f"{busy_ms:.3f} ms (port kernels {ours_ms:.3f} ms: {per}) = "
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
    from benor_tpu_torch.ops import sass
    from benor_tpu_torch.ops.stream import _EQUIV_SALT_OFFSET, stream_scal
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import PACK_K, FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs, random_inputs

    dev = torch.device("cuda")
    # --- 1. toolchain ----------------------------------------------------
    nvcc = [ln for ln in sh([_build.nvcc_path(), "--version"]).splitlines()
            if "release" in ln][0]
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc} | {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} | "
          f"{card}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"[build] {len(_build.sources())} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels = {}

    def record(name, nbytes, ops, ops_whole, n_diff, max_err, ms, plain_ms,
               library_ms=None):
        """One kernel's row of the kernels line.  ``ms`` holds the kernel's
        three repeats (the row takes their median); the bound is taken from
        ``ops`` (what this run's inputs need), the whole-draw count
        ``ops_whole`` is printed beside it."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        t_old = max(t_bytes, ops_whole / F32_OPS_PER_S * 1e3)
        src = ("round" if name in pr.KERNELS
               else "tally" if name in dk.KERNELS else "hist")
        kernels[name] = dict(
            name=name, route="cuda",
            source=f"benor_tpu_torch/csrc/{src}_kernels.cu",
            replaces=REPLACES[name], launches=0, max_abs_err=max_err,
            ms=median(ms), plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, match="exact", differing=n_diff,
            ms_repeats=ms)
        lib_txt = ("" if library_ms is None
                   else f"library {library_ms:.4f} ms, ")
        print(f"[time] {name}: kernel {ms} ms (median {median(ms):.4f}), "
              f"plain {plain_ms:.4f} ms, {lib_txt}bound "
              f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} for "
              f"{nbytes} B, operations {t_ops:.4f} for {ops} needed; "
              f"whole-draw count {ops_whole}, bound {t_old:.4f} ms)")

    # --- 2. kernels vs plain versions on the card -------------------------
    cfg = main_cfg()
    m, r = cfg.quorum, ROUND
    pack, hist1 = random_pack(cfg, dev, SEED)
    t, planes, n_w = pack.shape
    lanes = t * n_w * 32
    k_planes = planes - PACK_K
    pkey = stream_scal(SEED, r, rng.PHASE_PROPOSAL)
    vkey = stream_scal(SEED, r, rng.PHASE_VOTE)
    modes = MODES
    pack_bytes = pack.numel() * 4

    # the random fixture (the first port's): its times go into the kernels
    # line
    rnd = round_pair("random", lib, cfg, pack, hist1)
    plain_p, plain_v = (cuda_ms(fn, TIMED_LAUNCHES) for fn in rnd["plain"])
    nd = rnd["needs"]
    record("proposal_hist",
           pack_bytes + t * 3 * 4
           + pr.round_blocks(lib, 0, n_w, t, dev) * t * pr.PROP_COLS * 4,
           ops_needed("proposal_hist", lanes, t, n_w * t, k_planes,
                      draws=nd["proposal_draws"], tails=nd["proposal_tails"],
                      sizes=nd["proposal_sizes"]),
           lanes * ops_per_lane_whole("proposal_hist", planes),
           *rnd["res"][0], rnd["ms"]["proposal_hist"], plain_p)
    record("vote_commit",
           2 * pack_bytes + t * 4 * 4
           + pr.round_blocks(lib, 1, n_w, t, dev) * t * pr.VOTE_COLS * 4,
           ops_needed("vote_commit", lanes, t, n_w * t, k_planes,
                      draws=nd["vote_draws"], tails=nd["vote_tails"],
                      coins=nd["coins"], sizes=nd["vote_sizes"]),
           lanes * ops_per_lane_whole("vote_commit", planes),
           *rnd["res"][1], rnd["ms"]["vote_commit"], plain_v)

    # step 1's lines: registers, spills and shared memory (ptxas), the
    # static SASS mix by class, and each pipe's floor for these lanes at
    # the SM clock read while the vote kernel runs
    mhz = clock_during(rnd["calls"]["vote_commit"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    round_res = sass.resource_report(_build.CSRC / "round_kernels.cu",
                                     _build.BUILD_DIR)
    round_modes = {k: round_res.pop(k) for k in list(round_res) if "<" in k}
    fused_res = {k: round_res.pop(k) for k in sass.FUSED_KERNELS
                 if k in round_res}
    sass.print_resources("chip_smoke", round_res, lanes, sms, mhz)
    print(f"[clock] clocks.sm {mhz:.0f} MHz while vote_commit ran")

    # two more fixtures at the same shape: one edge histogram a trial (both
    # phases, the quorum gate false in every third trial), and whole warps
    # inactive (killed and decided-and-frozen runs, the gate false in every
    # fourth trial)
    qok_e = torch.arange(TRIALS, device=dev) % 3 != 2
    edge = round_pair("edge-histograms", lib, cfg, pack,
                      edge_hists(N_MAIN, m, TRIALS, dev),
                      edge_hists(N_MAIN, m, TRIALS, dev), qok_e)
    if not edge["needs"]["coins"]:
        raise SystemExit("the edge-histogram fixture coined no lane")
    del pack
    ipack, ihist = inactive_pack(cfg, dev, SEED + 2)
    round_pair("inactive-warps", lib, cfg, ipack, ihist,
               qok=torch.arange(TRIALS, device=dev) % 4 != 3)
    del ipack, edge, rnd

    # the fused round at every shape of its family (FUSED_FAMILY), each
    # against its plain version and the two-kernel route and timed beside
    # it, with its grid; N = 8192 x 32 gives the kernels line its numbers,
    # N = 10 x 1 (one word a warp) the latency probe's time
    family = fused_family(lib, dev)
    fits = pr.fused_fits(lib, dev)
    for (t_f, n_f), f in family.items():
        c_f, w_f = pr.fused_grid(lib, f["n_w"], t_f, dev)
        print(f"[grid] fused_round T={t_f} N={n_f}: {f['n_w']} words, C "
              f"{c_f} blocks a cluster, {w_f} warps a block, "
              f"{-(-f['n_w'] // (c_f * w_f))} words a warp, {t_f} clusters "
              f"({c_f * t_f} blocks; {fits[(c_f, w_f)]} such clusters fit "
              f"at once)")
    print(f"[grid] fused_round clusters that fit at once by (C, W): {fits}")
    cap = family[FUSED_FAMILY[0]]
    fcfg, fpack, fhist, out_p = cap["cfg"], cap["pack"], cap["hist"], cap["out"]
    fm_ = fcfg.quorum
    ft, fplanes, fn_w = fpack.shape
    flanes = ft * fn_w * 32
    plain = cuda_ms(lambda: pr.fused_round_plain(
        SEED, r, fhist, fpack, m=fm_, n_faulty=fcfg.n_faulty,
        rule="reference", **modes), TIMED_LAUNCHES)
    fneeds = lane_needs(fpack, (pkey, vkey), fm_, (fhist, out_p[1][:, :3]),
                        True, out_p[1][:, 3] >= fm_, out_p[0])
    record("fused_round",
           2 * fpack.numel() * 4 + ft * 3 * 4
           + ft * (pr.PROP_COLS + pr.VOTE_COLS) * 4,
           ops_needed("fused_round", flanes, ft, fn_w * ft,
                      fplanes - PACK_K,
                      draws=fneeds["proposal_draws"] + fneeds["vote_draws"],
                      tails=fneeds["proposal_tails"] + fneeds["vote_tails"],
                      coins=fneeds["coins"],
                      sizes=fneeds["proposal_sizes"]
                      + fneeds["vote_sizes"]),
           flanes * ops_per_lane_whole("fused_round", fplanes), *cap["res"],
           cap["ms"]["kernel"], plain)
    probe = family[(1, 10)]["ms"]
    kernels["fused_round"].update(
        two_kernel_ms=median(cap["ms"]["two_kernel"]),
        fused_wrapper_ms=median(cap["ms"]["fused"]),
        latency_probe_ms=median(probe["kernel"]),
        queued_ms=median(cap["ms"]["kernel_queued"]),
        two_kernel_queued_ms=median(cap["ms"]["two_kernel_queued"]),
        fused_wrapper_queued_ms=median(cap["ms"]["fused_queued"]),
        latency_probe_queued_ms=median(probe["kernel_queued"]))
    mhz_f = clock_during(cap["kernel"])
    sass.print_resources("chip_smoke", fused_res, flanes, sms, mhz_f,
                         latency_ms=median(probe["kernel_queued"]))
    print(f"[clock] clocks.sm {mhz_f:.0f} MHz while fused_round ran")
    del family, cap, fpack, out_p

    # the counts kernels at N = 1M x 32 on three fixtures; the unfused
    # path's balanced operands give the kernels line its times
    hlanes = TRIALS * N_MAIN
    cfx, efx = cf_fixtures(dev), equiv_fixtures(dev)
    hruns = {tag: hist_pair(tag, lib, cfx[tag], efx[tag]) for tag in cfx}
    hsizes = {tag: table_sizes(tag, cfx[tag], efx[tag]) for tag in cfx}
    # the grid's corners: one lane, one trial of a ragged N, more trials
    # than a wave holds blocks
    for t_g, n_g in GRID_CORNERS:
        g_hist = torch.tensor(np.random.default_rng(t_g).multinomial(
            n_g, [0.45, 0.45, 0.1], size=t_g), dtype=torch.int32, device=dev)
        g_ne = torch.full((t_g,), n_g // 5, dtype=torch.int32, device=dev)
        g_m = n_g - int(0.4 * n_g)
        args = (SEED, r, rng.PHASE_PROPOSAL, g_hist, g_m, n_g)
        compare(f"cf_counts T={t_g} N={n_g}", t_g * n_g,
                [(hk.cf_counts(*args), hk.cf_counts_plain(*args))])
        args = (SEED, r, rng.PHASE_VOTE, g_hist, g_ne, g_m, n_g)
        compare(f"equiv_counts T={t_g} N={n_g}", t_g * n_g,
                [(hk.equiv_counts(*args), hk.equiv_counts_plain(*args))])
    hbal = hruns["balanced"]
    print(f"[grid] blocks a trial: cf_counts "
          f"{hk.hist_blocks(lib, 0, N_MAIN, TRIALS, dev)}, equiv_counts "
          f"{hk.hist_blocks(lib, 1, N_MAIN, TRIALS, dev)} at T = {TRIALS}; "
          f"{hk.hist_blocks(lib, 0, N_RAGGED, T_RAGGED, dev)} and "
          f"{hk.hist_blocks(lib, 1, N_RAGGED, T_RAGGED, dev)} at T = "
          f"{T_RAGGED}")
    plain_c, plain_e = (cuda_ms(fn, TIMED_LAUNCHES) for fn in hbal["plain"])
    every = torch.ones((TRIALS, N_MAIN), dtype=torch.bool, device=dev)
    ekey2 = stream_scal(SEED, r, rng.PHASE_VOTE + _EQUIV_SALT_OFFSET)
    record("cf_counts", hlanes * 3 * 4 + TRIALS * 3 * 4,
           ops_needed("cf_counts", hlanes, trials=TRIALS,
                      tails=tail_quantiles(pkey, every),
                      sizes=hsizes["balanced"]["cf_counts"]),
           hlanes * ops_per_lane_whole("cf_counts"), *hbal["res"][0],
           hbal["ms"]["cf_counts"], plain_c)
    record("equiv_counts", hlanes * 3 * 4 + TRIALS * 4 * 4,
           ops_needed("equiv_counts", hlanes, trials=TRIALS,
                      tails=tail_quantiles(vkey, every)
                      + tail_quantiles(ekey2, every),
                      sizes=hsizes["balanced"]["equiv_counts"]),
           hlanes * ops_per_lane_whole("equiv_counts"), *hbal["res"][1],
           hbal["ms"]["equiv_counts"], plain_e)
    mhz_h = clock_during(hbal["calls"]["cf_counts"])
    sass.print_resources(
        "chip_smoke", sass.resource_report(_build.CSRC / "hist_kernels.cu",
                                           _build.BUILD_DIR,
                                           sass.HIST_KERNELS),
        hlanes, sms, mhz_h)
    print(f"[clock] clocks.sm {mhz_h:.0f} MHz while cf_counts ran")
    del cfx, efx, hruns, hbal, hsizes
    torch.cuda.empty_cache()

    # the coin kernels: both against their plain versions (the weak coin at
    # each of COIN_EPS) at N = 1M x 32, whose times go into the kernels
    # line, at the ragged N = 1,000,003 x 7 and at the grid's corners
    coins = coin_pair("balanced", lib, TRIALS, N_MAIN, dev)
    for t_c, n_c in ((T_RAGGED, N_RAGGED),) + COIN_CORNERS:
        coin_exact(f"T={t_c} N={n_c}", t_c, n_c, dev)
    print("[grid] " + coin_grid(lib, ((TRIALS, N_MAIN), (T_RAGGED, N_RAGGED))
                                + COIN_CORNERS, dev))
    plain_cf, plain_wc = (cuda_ms(fn, TIMED_LAUNCHES) for fn in coins["plain"])
    record("coin_flips", hlanes, ops_needed("coin_flips", hlanes),
           hlanes * ops_per_lane_whole("coin_flips"),
           *coins["res"]["coin_flips"], coins["ms"]["coin_flips"], plain_cf)
    record("weak_coin_flips", hlanes + TRIALS * 4,
           ops_needed("weak_coin_flips", hlanes),
           hlanes * ops_per_lane_whole("weak_coin_flips"),
           *coins["res"]["weak_coin_flips"], coins["ms"]["weak_coin_flips"],
           plain_wc)
    mhz_c = clock_during(coins["calls"]["coin_flips"])
    sass.print_resources(
        "chip_smoke", sass.resource_report(_build.CSRC / "hist_kernels.cu",
                                           _build.BUILD_DIR,
                                           sass.COIN_KERNELS),
        hlanes, sms, mhz_c, hk.COIN_NODES)
    print(f"[clock] clocks.sm {mhz_c:.0f} MHz while coin_flips ran")
    del coins
    torch.cuda.empty_cache()

    # the dense tally (dense_case) at bench.py's own T = 8, a ragged shape
    # for the byte tails, and last the main path's T = 32, whose times go
    # into the kernels line
    for t_d, r_d, s_d in ((8, N_DENSE, N_DENSE), (TRIALS, 1000, 2047),
                          (TRIALS, N_DENSE, N_DENSE)):
        ops = dense_case(t_d, r_d, s_d, dev)
        edges = t_d * r_d * s_d
        got = dk.dense_counts(*ops)
        want = dk.dense_counts_plain(*ops)
        via_bmm = tally.dense_counts(*ops)
        torch.cuda.synchronize()
        res = compare(f"dense_counts T={t_d} R={r_d} S={s_d}", edges,
                      [(got, want), (via_bmm, want)])
        ms = repeats(lambda: dk._launch_dense_counts(lib, *ops))
        plain = cuda_ms(lambda: dk.dense_counts_plain(*ops), TIMED_LAUNCHES)
        # the library route, timed whole: three compare-and-cast one-hot
        # columns, the bool -> f32 cast of the mask, torch.bmm, the int cast
        lib_ms = cuda_ms(lambda: tally.dense_counts(*ops), TIMED_LAUNCHES)
        nbytes = edges + 2 * t_d * s_d + t_d * r_d * 3 * 4
        if (t_d, r_d) != (TRIALS, N_DENSE):
            print(f"[time] dense_counts T={t_d} R={r_d} S={s_d}: kernel "
                  f"{ms} ms, plain {plain:.4f} ms, library (cast + bmm) "
                  f"{lib_ms:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {nbytes} "
                  f"B); the same buffers every launch, so a mask under the "
                  f"50 MB L2 is read from it")
        else:
            record("dense_counts", nbytes, ops_needed("dense_counts", edges),
                   edges * ops_per_lane_whole("dense_counts"), *res, ms, plain,
                   lib_ms)
        del ops, got, want, via_bmm
    torch.cuda.empty_cache()

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
    base = MAIN_RUN
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
    fused_runs = fused_run_cases(base, dev)
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
    for name, c, vals, fl in fused_runs:
        before = {k: fn.launches for k, fn in pr.KERNELS.items()}
        rounds, _ = drive("main", name, c, vals, fl)
        grown = {k: fn.launches - before[k] for k, fn in pr.KERNELS.items()}
        print(f"[main] {name}: {rounds} rounds, launches {grown}")
        if grown != {"proposal_hist": 0, "vote_commit": 0,
                     "fused_round": rounds}:
            raise SystemExit(f"{name}: not one fused_round launch a round")
    read_launches("main", pr.KERNELS)

    # where the time goes: state build vs the run, per regime
    t_runs = {}
    for name, c, vals, fl in regimes + fused_runs:
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
    name, c, vals, fl = regimes[-1]                      # balanced_f0.45
    st = init_state(c, vals, fl)
    breakdown("main", name, lambda: run_consensus(c, st, fl), t_runs[name],
              tuple(pr.KERNELS))
    del st

    # --- 6. the unfused path at full width -----------------------------------
    unfused = [(name, c.replace(use_pallas_round=False), vals, fl)
               for name, c, vals, fl in regimes]
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
    del st, regimes, fused_runs, unfused, bal, vals, fl
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

    # --- 8. the facade and delivery='all', the JAX package's default ---------
    dk.reset_launches()
    hk.reset_launches()
    pr.reset_launches()
    api_phase()
    split_compare(dev)

    abase = {**MAIN_RUN, "delivery": "all"}       # kernel switches on: unused
    # (name, config, inputs, no faults: else the first F lanes faulty)
    all_runs = [("iid_crash_f0.20",
                 SimConfig(n_nodes=N_MAIN, n_faulty=N_MAIN // 5, **abase),
                 random_inputs(SEED, TRIALS, N_MAIN), False)]
    bal = balanced_inputs(TRIALS, N_MAIN)
    all_runs += [(f"balanced_f{frac:.2f}",
                  SimConfig(n_nodes=N_MAIN, n_faulty=int(frac * N_MAIN),
                            **abase), bal, True)
                 for frac in FRACS]
    ones = np.ones((TRIALS, N_MAIN), np.int8)
    for f_eq in (F_EQUIV_TABLE, F_EQUIV_QUANTILE):
        c = SimConfig(n_nodes=N_MAIN, n_faulty=f_eq,
                      **{**abase, "fault_model": "equivocate"})
        all_runs.append((f"equiv_balanced_F{f_eq}", c, bal, False))
        all_runs.append((f"equiv_ones_F{f_eq}", c, ones, False))

    def all_faults(c, none):
        return (FaultSpec.none(TRIALS, N_MAIN, device=dev) if none
                else FaultSpec.first_f(c, device=dev))

    for name, c, vals, none in all_runs:
        assert not tally.pallas_round_active(c)
        rounds, fin = drive("all", name, c, vals, all_faults(c, none))
        if name.startswith("equiv_ones"):
            # validity: every honest lane starts at 1, so 1 is decided
            if not bool((fin.decided & (fin.x != 1)).sum() == 0):
                raise SystemExit(f"{name}: validity violated")
            print(f"[all] {name}: validity held (every decided lane holds 1)")
        del fin
    launched = {k: fn.launches for k, fn in (*dk.KERNELS.items(),
                                             *hk.KERNELS.items(),
                                             *pr.KERNELS.items())}
    print(f"[all] kernel launches on the facade and 'all' runs: {launched}")
    if any(launched.values()):
        raise SystemExit("a kernel launched on the delivery='all' path")

    # where the time goes: state build vs the run, then one profiled run
    t_all = {}
    for name, c, vals, none in all_runs:
        fl = all_faults(c, none)
        t0 = time.perf_counter()
        st = init_state(c, vals, fl)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        rounds, _ = run_consensus(c, st, fl)
        torch.cuda.synchronize()
        t_run = t_all[name] = time.perf_counter() - t0
        print(f"[all] split {name}: init_state {t_init:.4f} s, run_consensus "
              f"{t_run:.4f} s ({rounds} rounds, {c.trials / t_run:.3f} "
              f"trials/s over run_consensus alone)")
    for name, c, vals, none in (all_runs[5], all_runs[-2]):
        fl = all_faults(c, none)
        st = init_state(c, vals, fl)
        breakdown("all", name, lambda: run_consensus(c, st, fl), t_all[name],
                  (), torch_ops=True)
    del st, fl, all_runs, bal, ones
    torch.cuda.empty_cache()

    # the card against the CPU: crash at N = 65,536 x 32 (iid inputs with
    # F crashed from birth; balanced inputs, which tie round 1 and take the
    # coin), and equivocate at N = 8192 x 8 by both split samplers (the
    # exact table at F = 0.2 N, the normal quantile with EXACT_TABLE_MAX
    # lowered below F)
    n_c = N_ALL_CPU
    cmp_runs = [
        ("iid_crash_f0.20", SimConfig(n_nodes=n_c, n_faulty=n_c // 5,
                                      **abase),
         random_inputs(SEED, TRIALS, n_c), False, None),
        ("balanced_f0.45", SimConfig(n_nodes=n_c, n_faulty=int(0.45 * n_c),
                                     **abase),
         balanced_inputs(TRIALS, n_c), True, None),
    ]
    ce = SimConfig(n_nodes=N_ALL_SMALL, n_faulty=N_ALL_SMALL // 5,
                   **{**abase, "trials": 8, "fault_model": "equivocate"})
    cmp_runs += [("equiv_table", ce, balanced_inputs(8, N_ALL_SMALL), False,
                  None),
                 ("equiv_quantile", ce, balanced_inputs(8, N_ALL_SMALL),
                  False, 1000)]
    old = sampling.EXACT_TABLE_MAX
    for name, c, vals, none, table_max in cmp_runs:
        sampling.EXACT_TABLE_MAX = table_max or old
        try:
            outs = {}
            for d in ("cuda", "cpu"):
                fl = (FaultSpec.none(c.trials, c.n_nodes, device=d) if none
                      else FaultSpec.first_f(c, device=d))
                t0 = time.perf_counter()
                rr, fin = run_consensus(c, init_state(c, vals, fl), fl)
                check_final(c, rr, fin)
                outs[d] = (rr, fin, time.perf_counter() - t0)
        finally:
            sampling.EXACT_TABLE_MAX = old
        (rg, fg, tg), (rc, fc, tc) = outs["cuda"], outs["cpu"]
        diff = trials_differing(fg, fc)
        print(f"[all] card vs cpu {name} N={c.n_nodes} F={c.n_faulty} "
              f"T={c.trials}: rounds cuda {rg} cpu {rc}, trials differing "
              f"{diff} of {c.trials} (cpu {tc:.2f} s, card {tg:.3f} s)")
        if rg != rc or diff:
            raise SystemExit(f"[all] {name}: card and CPU runs disagree")

    # --- 9. equivocation, the shared coins and the count adversaries -------
    item8_phase(lib, dev, sms, round_modes)

    # --- 10. the kernels line, the card, the result ------------------------
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# --- the [item8] phase: equivocation, the shared coins and the count
# adversaries in the round kernels ------------------------------------------

# the regimes whose packed and unfused runs share every random bit (the
# common coin under the count adversary, sampled equivocation with the
# private coin), and those whose structure forbids any decision (the bar
# m <= F; the N > 3F impossibility)
ITEM8_EXACT = ("adv_common", "equiv_3f_sub", "equiv_3f_super",
               "equiv_uniform_f0.20")
ITEM8_NO_DECISION = ("targeted_f0.50", "equiv_3f_super")
# the card-vs-CPU sizes: (N, T) whose sampled modes take the fused kernel,
# and the two-kernel route
ITEM8_SMALL = ((8192, 8), (16_384, 4))
# the round kernels' new instantiations on N = 1M x 32 fixtures: (counts,
# coin, fault model); the fused kernel's on its shape family: (coin, fault
# model); each list led by the main path's instantiation on the same kind
# of fixture, the control its times are read against
ITEM8_PAIR = (("sampled", "private", "crash"),       # the main path's
              ("sampled", "private", "equivocate"),
              ("sampled", "common", "crash"),
              ("sampled", "weak_common", "crash"),
              ("sampled", "common", "equivocate"),
              ("sampled", "weak_common", "equivocate"),
              ("delivered", "private", "crash"),
              ("delivered", "common", "crash"),
              ("delivered", "weak_common", "crash"),
              ("delivered", "private", "equivocate"),
              ("delivered", "common", "equivocate"),
              ("delivered", "weak_common", "equivocate"),
              ("camps", "private", "crash"),
              ("camps", "common", "crash"),
              ("camps", "weak_common", "crash"),
              ("camps", "private", "equivocate"),
              ("camps", "common", "equivocate"),
              ("camps", "weak_common", "equivocate"))
ITEM8_FUSED = (("private", "crash"), ("private", "equivocate"),
               ("common", "crash"),
               ("weak_common", "crash"), ("common", "equivocate"),
               ("weak_common", "equivocate"))
ITEM8_EPS = 0.5           # the weak coin's deviation rate in the fixtures
# a lane's work for its tallies beyond the pair's plane reads and logic:
# the equivocate draw (two threefry blocks, four uniforms, three samples,
# ~16 sums, clamps and the split; the terms of its two sample sizes are
# charged once per distinct (trial, size), as equiv_counts' are); the camp
# choice (two compares, two selects); the weak coin's deviation test
OPS_EQUIV_LANE = (2 * OPS_THREEFRY + 4 * OPS_UNIFORM + 3 * OPS_CF_SAMPLE
                  + 16)
OPS_EQUIV_TRIAL = 80
OPS_CAMP_LANE = 4
OPS_WEAK_COIN = OPS_THREEFRY + 1 + OPS_UNIFORM + 2


def item8_regimes(n, trials, max_rounds=MAX_ROUNDS, device="cuda"):
    """bench.py's nine regimes that run the round kernels' new branches
    (bench.py:337-406) at ``n`` x ``trials``, with bench.py's even-quorum
    adjustments and round caps -> [(name, cfg, inputs, faults)]."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs

    base = dict(n_nodes=n, trials=trials, max_rounds=max_rounds,
                delivery="quorum", path="histogram", fault_model="crash",
                seed=SEED, use_pallas_hist=True, use_pallas_round=True)
    bal = balanced_inputs(trials, n)
    out = []

    def add(name, alive_eq, **kw):
        c = SimConfig(**{**base, **kw})
        fl = (FaultSpec.first_f(c, device=device) if alive_eq
              else FaultSpec.none(trials, n, device=device))
        out.append((name, c, bal, fl))

    def even(f):
        return f + (n - f) % 2          # an even quorum N - F

    cap12 = min(12, max_rounds)
    f_adv = even(int(0.2 * n))
    add("adv_private", False, scheduler="adversarial", coin_mode="private",
        n_faulty=f_adv, max_rounds=cap12)
    add("adv_common", False, scheduler="adversarial", coin_mode="common",
        n_faulty=f_adv)
    for eps in (0.55, 0.65):
        add(f"weak_eps{eps}", False, scheduler="adversarial",
            coin_mode="weak_common", adversary_strength=0.0, coin_eps=eps,
            n_faulty=even(int(0.4 * n)), max_rounds=cap12)
    for name, f, cap in (("targeted_f0.25", even(int(0.25 * n)), 16),
                         ("targeted_f0.50", n // 2 + 1, 12)):
        add(name, False, scheduler="targeted", n_faulty=f,
            max_rounds=min(cap, max_rounds), use_pallas_hist=False)
    f_sub = n // 3 - (1 if n % 3 == 0 else 0)
    for name, f, cap in (("equiv_3f_sub", f_sub, max_rounds),
                         ("equiv_3f_super", n // 3 + 1, cap12)):
        add(name, True, scheduler="adversarial", coin_mode="common",
            fault_model="equivocate", n_faulty=f, max_rounds=cap,
            use_pallas_hist=False)
    add("equiv_uniform_f0.20", True, scheduler="uniform",
        fault_model="equivocate", n_faulty=int(0.2 * n))
    return out


def item8_small_extra(n, trials, device="cuda"):
    """The sampled counts under the shared coins, for the card-vs-CPU runs
    (the uniform scheduler at f = 0.40 under the common and the weak coin,
    equivocate at f = 0.20 under the weak coin)."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs

    base = dict(n_nodes=n, trials=trials, max_rounds=MAX_ROUNDS,
                delivery="quorum", path="histogram", scheduler="uniform",
                seed=SEED, use_pallas_hist=True, use_pallas_round=True)
    bal = balanced_inputs(trials, n)
    out = []
    for name, kw in (("uniform_common_f0.40",
                      dict(coin_mode="common", n_faulty=int(0.4 * n))),
                     ("uniform_weak_f0.40",
                      dict(coin_mode="weak_common", coin_eps=ITEM8_EPS,
                           n_faulty=int(0.4 * n))),
                     ("equiv_uniform_weak_f0.20",
                      dict(coin_mode="weak_common", coin_eps=ITEM8_EPS,
                           fault_model="equivocate",
                           n_faulty=int(0.2 * n)))):
        c = SimConfig(**base, **kw)
        fl = (FaultSpec.first_f(c, device=device)
              if c.fault_model == "equivocate"
              else FaultSpec.none(trials, n, device=device))
        out.append((name, c, bal, fl))
    return out


def mode_ops(kernel, lanes, trials, words, k_planes, counts_mode, coin_mode,
             equiv, draws, tails, sizes, coins) -> int:
    """Operations a round kernel's instantiation needs on this run's
    inputs (see ``ops_needed``): ``draws`` lanes that read their tallies
    (``tails`` of their quantiles in the tail; ``sizes`` distinct (trial,
    sample size) of the draws whose size is the lane's own: the CF pair's
    second, the equivocate tally's h0 and h1), ``coins`` lanes that take the
    coin."""
    base = (OPS_READ_PLANES + 15 if kernel == "proposal_hist"
            else OPS_READ_PLANES + 4 + 31)
    ops = lanes * base
    if kernel == "vote_commit":
        ops += words * 2 * k_planes
        ops += coins * {"private": OPS_THREEFRY + 1, "common": 0,
                        "weak_common": OPS_WEAK_COIN}[coin_mode]
    if counts_mode == "camps":
        ops += draws * OPS_CAMP_LANE
    elif counts_mode == "sampled" and equiv:
        ops += (draws * OPS_EQUIV_LANE + sizes * OPS_CF_TERMS
                + ops_quantiles(4 * draws, tails) + trials * OPS_EQUIV_TRIAL)
    elif counts_mode == "sampled":
        ops += (draws * OPS_CF_PAIR_LANE + sizes * OPS_CF_TERMS
                + ops_quantiles(2 * draws, tails) + trials * OPS_CF_TRIAL)
    return ops


def mode_case(cfg, counts_mode, fault_model, device, seed, balanced=False):
    """A plane stack of a random mid-run state for ``cfg`` in a mode
    (``balanced``: see ``random_pack``), its
    proposal histogram, live equivocators and camp bounds, the kernels'
    closed form for the mode (``counts``: a histogram -> the kernels' count
    operand) and a shared coin bit a trial."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import tally

    sched = {"sampled": "uniform", "delivered": "adversarial",
             "camps": "targeted"}[counts_mode]
    cfg = cfg.replace(scheduler=sched, fault_model=fault_model,
                      delivery="quorum")
    pack, _ = random_pack(cfg, device, seed, balanced)
    hist1 = pr.sent_hist_from_pack(cfg, pack)
    n_equiv = pr.n_equiv_from_pack(cfg, pack)
    camps = (tally.targeted_camp_bounds(cfg) if counts_mode == "camps"
             else (0, 0))

    def counts(h):
        if counts_mode == "delivered":
            return tally.adversarial_counts(h, cfg.quorum, n_free=n_equiv)
        if counts_mode == "camps":
            return tally.targeted_camp_triples(cfg, h, n_free=n_equiv)
        return h

    g = torch.Generator(device=device).manual_seed(seed)
    shared = torch.randint(0, 2, (cfg.trials,), generator=g, device=device,
                           dtype=torch.int32)
    return dict(cfg=cfg, pack=pack, hist1=hist1, n_equiv=n_equiv,
                camps=camps, counts=counts, shared=shared)


def mode_needs(pack, counts_mode, equiv, m, hists, qok, new_pack,
               n_equiv=None) -> dict:
    """What a round's lanes need in a mode (see ``lane_needs``): the lanes
    that read their tallies in each phase, their quantiles in the tail
    (the equivocate draw's four uniforms, the CF pair's two) and the
    distinct (trial, sample size) of the draws whose size is the lane's own
    (the CF pair's second; the equivocate tally's h0 and h1, ``n_equiv``
    its live equivocators); the lanes that coin (the vote's new coined
    plane).  ``hists``: the two phases' counts."""
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.packed_round import plane_field
    from benor_tpu_torch.ops.stream import _EQUIV_SALT_OFFSET, stream_scal
    from benor_tpu_torch.state import PACK_COINED, PACK_DECIDED, PACK_KILLED

    live = ((plane_field(pack, PACK_KILLED, 1) == 0)
            & (plane_field(pack, PACK_DECIDED, 1) == 0))
    needs = {"coins": int(plane_field(new_pack, PACK_COINED, 1).sum())}
    for ph, need, hist in ((rng.PHASE_PROPOSAL, live, hists[0]),
                           (rng.PHASE_VOTE, live & qok[:, None], hists[1])):
        name = "proposal" if ph == rng.PHASE_PROPOSAL else "vote"
        needs[f"{name}_draws"] = int(need.sum())
        needs[f"{name}_tails"] = needs[f"{name}_sizes"] = 0
        if counts_mode != "sampled":
            continue
        key = stream_scal(SEED, ROUND, ph)
        needs[f"{name}_tails"] = tail_quantiles(key, need)
        if equiv:
            needs[f"{name}_tails"] += tail_quantiles(
                stream_scal(SEED, ROUND, ph + _EQUIV_SALT_OFFSET), need)
            needs[f"{name}_sizes"] = sum(
                distinct_sizes(x, need) for x, _ in equiv_sizes(
                    hist, n_equiv, m, need.shape[1], ph))
        else:
            needs[f"{name}_sizes"] = distinct_sizes(pair_sizes(
                key, hist, m, need.shape, need.device)[0], need)
    return needs


def mode_pair(lib, cfg, counts_mode, coin_mode, fault_model, device,
              seed) -> dict:
    """proposal_hist and vote_commit in one mode against their plain
    versions on a random N = 1M x 32 fixture (F = 0.4 N, so the closed
    forms tie; the vote on the proposal's gate and on a balanced histogram
    of its voters, so that lanes coin; a random shared bit a trial), then
    three timed repeats of each launch ->
    dict: res (the two compare results), ms, needs, bytes, ops."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.stream import (_COIN_SALT, _EQUIV_SALT_OFFSET,
                                            stream_scal)
    from benor_tpu_torch.state import PACK_K

    case = mode_case(cfg, counts_mode, fault_model, device, seed)
    cfg, pack = case["cfg"], case["pack"]
    m, r = cfg.quorum, ROUND
    t, planes, n_w = pack.shape
    lanes = t * n_w * 32
    eps = ITEM8_EPS if coin_mode == "weak_common" else 0.0
    tag = f"{counts_mode}/{coin_mode}/{fault_model}"
    pm = dict(fault_model=fault_model, freeze=True, n_equiv=case["n_equiv"],
              counts_mode=counts_mode, camp_b0=case["camps"][0],
              camp_b1=case["camps"][1])
    vm = dict(pm, coin_mode=coin_mode, eps=eps, shared=case["shared"])
    c1 = case["counts"](case["hist1"])
    parts_k = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, c1, pack, m,
                               **pm)
    parts_p = pr.proposal_hist_plain(SEED, r, rng.PHASE_PROPOSAL, c1, pack,
                                     m, **pm)
    torch.cuda.synchronize()
    res_p = compare(f"proposal_hist {tag}", lanes, [(parts_k, parts_p)])
    qok = parts_p[:, 3] >= m
    # a balanced vote histogram, so that the tallies tie and lanes coin
    tot = parts_p[:, :3].sum(1)
    c2 = case["counts"](torch.stack([tot // 2, tot - tot // 2, tot * 0],
                                    dim=1))
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="reference")
    new_k, vparts_k = pr.vote_commit(SEED, r, rng.PHASE_VOTE, c2, pack, qok,
                                     **vote, **vm)
    new_p, vparts_p = pr.vote_commit_plain(SEED, r, rng.PHASE_VOTE, c2,
                                           pack, qok, **vote, **vm)
    torch.cuda.synchronize()
    res_v = compare(f"vote_commit {tag}", lanes, [(new_k, new_p),
                                                  (vparts_k, vparts_p)])

    equiv = counts_mode == "sampled" and fault_model == "equivocate"
    needs = mode_needs(pack, counts_mode, equiv, m, (c1, c2), qok, new_p,
                       case["n_equiv"])
    keys = {s: stream_scal(SEED, r, s) for s in (
        rng.PHASE_PROPOSAL, rng.PHASE_VOTE, _COIN_SALT,
        rng.PHASE_PROPOSAL + _EQUIV_SALT_OFFSET,
        rng.PHASE_VOTE + _EQUIV_SALT_OFFSET)}
    del new_k, new_p
    if coin_mode != "private" and not needs["coins"]:
        raise SystemExit(f"{tag}: the fixture coined no lane")

    hist_f1, hist_f2 = (pr.kernel_vecs(c, counts_mode) for c in (c1, c2))
    ne_f = (case["n_equiv"].to(torch.float32).contiguous() if equiv
            else None)
    qok_i = qok.to(torch.int32).contiguous()
    two = ((0, 0), (0, 0))
    if equiv:
        two = tuple(keys[p + _EQUIV_SALT_OFFSET]
                    for p in (rng.PHASE_PROPOSAL, rng.PHASE_VOTE))
    shared_i = None if coin_mode == "private" else case["shared"]
    calls = {
        "proposal_hist": lambda: pr._launch_proposal_hist(
            lib, keys[rng.PHASE_PROPOSAL], hist_f1, pack, m, fault_model,
            True, counts_mode, two[0], ne_f, case["camps"]),
        "vote_commit": lambda: pr._launch_vote_commit(
            lib, keys[rng.PHASE_VOTE], keys[_COIN_SALT], r + 1, hist_f2,
            qok_i, pack, m, cfg.n_faulty, "reference", fault_model, True,
            counts_mode, coin_mode, two[1], ne_f, shared_i, eps,
            case["camps"]),
    }
    ms = {k: repeats(fn) for k, fn in calls.items()}
    pack_bytes = pack.numel() * 4
    nvec = hist_f1.shape[1]
    bytes_ = {
        "proposal_hist": pack_bytes + t * nvec * 4
        + pr.round_blocks(lib, 0, n_w, t, device,
                          pr._mode_ids(counts_mode, "private", fault_model))
        * t * pr.PROP_COLS * 4,
        "vote_commit": 2 * pack_bytes + t * (nvec + 2) * 4
        + pr.round_blocks(lib, 1, n_w, t, device,
                          pr._mode_ids(counts_mode, coin_mode, fault_model))
        * t * pr.VOTE_COLS * 4,
    }
    ops = {k: mode_ops(k, lanes, t, n_w * t, planes - PACK_K, counts_mode,
                       coin_mode, equiv,
                       needs[f"{p}_draws"], needs[f"{p}_tails"],
                       needs[f"{p}_sizes"], needs["coins"])
           for k, p in (("proposal_hist", "proposal"),
                        ("vote_commit", "vote"))}
    print(f"[fixture] item8 {tag}: lanes {lanes}, needs {needs}; kernel ms "
          f"{ms}")
    return dict(res=(res_p, res_v), ms=ms, needs=needs, bytes=bytes_,
                ops=ops, calls=calls, tag=tag)


def mode_fused(lib, trials, n, coin_mode, fault_model, device, timed):
    """fused_round in one mode on a balanced random_pack fixture of
    ``trials`` x ``n`` (F = 0.4 N and the textbook rule: no tally passes F,
    so every active lane coins; a random shared bit a trial) against its
    plain version and
    against the two-kernel route, bit for bit; with ``timed`` three timed
    repeats of its launch, as every kernel is and queued -> dict."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.state import PACK_COINED, PACK_K

    cfg = main_cfg().replace(n_nodes=n, n_faulty=int(0.4 * n),
                             trials=trials)
    case = mode_case(cfg, "sampled", fault_model, device, SEED + 3,
                     balanced=True)
    cfg, pack, hist = case["cfg"], case["pack"], case["hist1"]
    m, r = cfg.quorum, ROUND
    lanes = trials * pack.shape[2] * 32
    eps = ITEM8_EPS if coin_mode == "weak_common" else 0.0
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="textbook",
                fault_model=fault_model, freeze=True)
    modes = dict(n_equiv=case["n_equiv"], coin_mode=coin_mode, eps=eps,
                 shared=case["shared"])
    out_k = pr.fused_round(SEED, r, hist, pack, **vote, **modes)
    out_p = pr.fused_round_plain(SEED, r, hist, pack, **vote, **modes)
    parts_a = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist, pack, m,
                               fault_model, True, n_equiv=case["n_equiv"])
    out_2 = (*pr.vote_commit(SEED, r, rng.PHASE_VOTE, parts_a[:, :3], pack,
                             parts_a[:, 3] >= m, **vote, **modes), parts_a)
    out_2 = (out_2[0], out_2[2], out_2[1])
    torch.cuda.synchronize()
    tag = f"{coin_mode}/{fault_model} T={trials} N={n}"
    res = compare(f"fused_round {tag}", lanes, list(zip(out_k, out_p)))
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_2))
    print(f"[dispatch] item8 fused_round vs proposal_hist + sum + "
          f"vote_commit at {tag}: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"fused and two-kernel rounds differ at {tag}")
    coins = int(pr.plane_field(out_p[0], PACK_COINED, 1).sum())
    if not coins and n >= 1024:
        raise SystemExit(f"{tag}: the fixture coined no lane")
    out = dict(res=res, lanes=lanes, grid=pr.fused_grid(
        lib, pack.shape[2], trials, device, coin_mode,
        fault_model == "equivocate"))
    if timed:
        def fused():
            return pr.fused_round(SEED, r, hist, pack, **vote, **modes)
        out["ms"] = repeats(fused)
        out["ms_queued"] = repeats(fused, queued=True)
        out["bytes"] = 2 * pack.numel() * 4 + trials * 3 * 4 \
            + trials * (pr.PROP_COLS + pr.VOTE_COLS) * 4
        equiv = fault_model == "equivocate"
        nd = mode_needs(pack, "sampled", equiv, m, (hist, out_p[1][:, :3]),
                        out_p[1][:, 3] >= m, out_p[0], case["n_equiv"])
        t, planes, n_w = pack.shape
        out["needs"] = nd
        out["ops"] = sum(mode_ops(k, lanes, t, n_w * t, planes - PACK_K,
                                  "sampled", coin_mode, equiv,
                                  nd[f"{p}_draws"], nd[f"{p}_tails"],
                                  nd[f"{p}_sizes"], nd["coins"])
                         for k, p in (("proposal_hist", "proposal"),
                                      ("vote_commit", "vote")))
    return out


def item8_phase(lib, dev, sms, round_modes) -> None:
    """The [item8] phase (see the module docstring): the round kernels'
    new instantiations against their plain versions and timed, their
    resources; bench.py's nine regimes at N = 1M x 32 on the packed path
    with the launch counts read around them; packed against unfused on the
    four regimes where they share every bit; card against CPU at small
    sizes.  Any differing word, count or run raises SystemExit."""
    import torch
    from benor_tpu_torch import simulate
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import sass
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import init_state

    t_phase = time.perf_counter()
    cfg = main_cfg().replace(n_faulty=int(0.4 * N_MAIN))

    def bound(nbytes, ops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    # 1. every new instantiation of the pair on N = 1M x 32, timed once;
    # ``held``: the instantiations held against their plain versions
    held = set()
    pair_calls = {}
    for i, (cm, coin, fm) in enumerate(ITEM8_PAIR):
        res = mode_pair(lib, cfg, cm, coin, fm, dev, SEED + 10 + i)
        counts, coin_id, equiv, honest = pr._mode_ids(cm, coin, fm)
        pop = 2 if equiv else honest     # csrc/round_kernels.cu Pop
        insts = {"proposal_hist": sass.mode_label(
                     "proposal_hist_kernel", (counts, pop)),
                 "vote_commit": sass.mode_label(
                     "vote_commit_kernel", (counts, coin_id, pop))}
        for k, inst in insts.items():
            if inst in held:
                continue
            held.add(inst)
            pair_calls[inst] = res["calls"][k]
            b_ms, by = bound(res["bytes"][k], res["ops"][k])
            med = median(res["ms"][k])
            ctl = "" if "<" in inst else " control"
            print(f"[time] item8{ctl} {inst} ({res['tag']}): kernel "
                  f"{res['ms'][k]} ms (median {med:.4f}), bound {b_ms:.4f} "
                  f"ms ({by}; bytes {res['bytes'][k]} B, operations "
                  f"{res['ops'][k]} needed), share {b_ms / med:.3f}; "
                  f"library null")
        del res
        torch.cuda.empty_cache()

    # 2. every new instantiation of the fused kernel, on its shape family,
    # timed at its cap N = 8192 x 32
    for coin, fm in ITEM8_FUSED:
        for t_f, n_f in FUSED_FAMILY:
            f = mode_fused(lib, t_f, n_f, coin, fm, dev,
                           (t_f, n_f) == FUSED_FAMILY[0])
            equiv = fm == "equivocate"
            inst = sass.mode_label("fused_cluster_kernel"
                                   if f["grid"][0] > 1
                                   else "fused_round_kernel",
                                   (pr.COIN_MODES.index(coin), int(equiv)))
            held.add(inst)
            if "ms" not in f:
                continue
            b_ms, by = bound(f["bytes"], f["ops"])
            ctl = "" if "<" in inst else " control"
            print(f"[time] item8{ctl} {inst} ({coin}/{fm}, T={t_f} N={n_f}, "
                  f"grid {f['grid']}, needs {f['needs']}): fused wrapper "
                  f"{f['ms']} ms (median {median(f['ms']):.4f}), queued "
                  f"{f['ms_queued']} ms (median "
                  f"{median(f['ms_queued']):.4f}); bound {b_ms:.5f} ms "
                  f"({by}; bytes {f['bytes']} B, operations {f['ops']} "
                  f"needed), share queued "
                  f"{b_ms / median(f['ms_queued']):.3f}; library null")

    # 3. their registers, spills and SASS: the pair's at N = 1M x 32, the
    # fused kernel's at 8192 x 32, at the clock read while the first new
    # vote instantiation runs
    mhz = clock_during(next(v for k, v in pair_calls.items()
                            if k.startswith("vote_commit_kernel<")))
    pair_res = {k: v for k, v in round_modes.items()
                if not k.startswith("fused")}
    fused_res = {k: v for k, v in round_modes.items()
                 if k.startswith("fused")}
    sass.print_resources("item8", pair_res, TRIALS * N_MAIN, sms, mhz)
    sass.print_resources("item8", fused_res, TRIALS * N_FUSED, sms, mhz)
    spills = {k: (v.get("spill_stores"), v.get("spill_loads"))
              for k, v in round_modes.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    untried = sorted(set(round_modes) - held)
    if untried:
        raise SystemExit(f"[item8] instantiations never held against their "
                         f"plain versions: {untried}")
    print(f"[ptxas] item8: {len(round_modes)} new instantiations, clocks.sm "
          f"{mhz:.0f} MHz; spilling: {spills or 'none'}")

    # 4. the nine regimes at N = 1M x 32 on the packed path
    regimes = item8_regimes(N_MAIN, TRIALS, device=dev)
    packed = {}
    pr.reset_launches()
    hk.reset_launches()
    for name, c, vals, fl in regimes:
        before = {k: fn.launches for k, fn in pr.KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        split = check_final(c, rounds, fin, agreement=False)
        live = int((~fin.killed).sum())
        dec = int(fin.decided.sum()) / max(live, 1)
        grown = {k: fn.launches - before[k] for k, fn in pr.KERNELS.items()}
        print(f"[item8] {name}: N={c.n_nodes} F={c.n_faulty} T={c.trials} "
              f"max_rounds {c.max_rounds}: rounds {rounds} decided {dec:.6f} "
              f"disagreeing trials {split} simulate {sec:.4f} s trials/s "
              f"{c.trials / sec:.3f}; launches {grown}")
        if name in ITEM8_NO_DECISION and bool(fin.decided.any()):
            raise SystemExit(f"{name}: a lane decided")
        if grown["fused_round"] or not grown["vote_commit"]:
            raise SystemExit(f"{name}: not the two-kernel route")
        packed[name] = (rounds, fin) if name in ITEM8_EXACT else None
        del fin
    launched = {k: fn.launches for k, fn in (*pr.KERNELS.items(),
                                             *hk.KERNELS.items())}
    print(f"[item8] launches {launched}")
    if not (launched["proposal_hist"] and launched["vote_commit"]):
        raise SystemExit("[item8] the pair never launched")
    if any(fn.launches for fn in hk.KERNELS.values()):
        raise SystemExit("[item8] a histogram kernel ran on the packed path")
    # the init_state / run_consensus split
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
        print(f"[item8] split {name}: init_state {t_init:.4f} s, "
              f"run_consensus {t_run:.4f} s ({rounds} rounds, "
              f"{c.trials / t_run:.3f} trials/s over run_consensus alone)")
    # adv_common (2 rounds, a delivered round) and weak_eps0.65 (12
    # rounds under the shared coin's host-side draw)
    for name, c, vals, fl in (regimes[1], regimes[3]):
        st = init_state(c, vals, fl)
        breakdown("item8", name, lambda: run_consensus(c, st, fl),
                  t_runs[name], tuple(pr.KERNELS))
        del st

    # 5. packed against unfused where they share every random bit
    for name, c, vals, fl in regimes:
        if name not in ITEM8_EXACT:
            continue
        p_rounds, p_fin = packed.pop(name)
        u = c.replace(use_pallas_round=False)
        rounds, fin, _ = simulate(u, vals, faults=fl, device="cuda")
        diff = trials_differing(fin, p_fin)
        print(f"[item8] {name} unfused vs packed: rounds {rounds} vs "
              f"{p_rounds}, trials differing {diff} of {c.trials}")
        if rounds != p_rounds or diff:
            raise SystemExit(f"{name}: unfused and packed runs differ")
        del fin, p_fin
    del regimes, packed
    torch.cuda.empty_cache()

    # 6. the card against the CPU at small sizes: every new mode
    for n_s, t_s in ITEM8_SMALL:
        for d_runs in zip(item8_regimes(n_s, t_s, device="cuda")
                          + item8_small_extra(n_s, t_s, "cuda"),
                          item8_regimes(n_s, t_s, device="cpu")
                          + item8_small_extra(n_s, t_s, "cpu")):
            outs = {}
            before = {k: fn.launches for k, fn in pr.KERNELS.items()}
            for name, c, vals, fl in d_runs:
                t0 = time.perf_counter()
                rr, fin = run_consensus(c, init_state(c, vals, fl), fl)
                check_final(c, rr, fin, agreement=False)
                outs[fl.faulty.device.type] = (rr, fin,
                                               time.perf_counter() - t0)
            grown = {k: fn.launches - before[k]
                     for k, fn in pr.KERNELS.items()}
            (rg, fg, tg), (rc, fc, tc) = outs["cuda"], outs["cpu"]
            diff = trials_differing(fg, fc)
            print(f"[item8] card vs cpu {name} N={n_s} T={t_s}: rounds cuda "
                  f"{rg} cpu {rc}, trials differing {diff} of {t_s} (cpu "
                  f"{tc:.2f} s, card {tg:.3f} s); card launches {grown}")
            if rg != rc or diff:
                raise SystemExit(f"[item8] {name} N={n_s}: card and CPU "
                                 "runs disagree")
            if pr.fused_one_pass_eligible(c, t_s, n_s) != bool(
                    grown["fused_round"]):
                raise SystemExit(f"[item8] {name} N={n_s}: dispatch")
    print(f"[item8] phase {time.perf_counter() - t_phase:.1f} s")


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
