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
     torch with no kernel: each scenario of tests/test_scenarios.py, the
     upstream default launch and a launch whose faulty nodes die at rounds
     2 and 3 (``crash_at_round``, ``crash_rounds``) through
     ``launch_network`` on the card and on the CPU, state for state equal, the livelock scenario again
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
 10. ``[b2]``: crash_at_round and crash_recover in the round kernels.
     Every instantiation of their FaultRounds modes (csrc/round_b2.cu)
     against its plain version on N = 1M x 32 fixtures with 45 % of the
     lanes faulty and round bounds that put faulty lanes in every class
     at round 3 (crashing, down, never rejoining, rejoining now decided
     and undecided, back, untouched), every count and plane word (killed
     and down included), and of fused_round on its shape family against
     its plain version and the two-kernel route, each timed beside the
     main path's instantiation with its bound (the bounds' bytes counted),
     registers, spills and SASS; five regimes at N = 1M x 32 with the
     launch counts read around them (the first F = 0.45 N lanes crash at
     round 2; 'at:1:4' durable and amnesia; 'stagger:1:4:amnesia' at
     F = 0.25 N; 'at:2:0', which must equal the first), the recover ones
     to their rejoin round; two N = 8192 runs on the fused kernel alone;
     the split, the per-round ``sent_hist_from_pack`` alone and one
     profiled run; packed against unfused on 'at:1:4' durable and
     amnesia; card against CPU at 8192 x 8 and 16,384 x 4 in every mode
     combination;
 11. ``[obs]``: the flight recorder, the witness and the stage counters in
     the round kernels' armed twins (csrc/round_obs.cu,
     csrc/round_obs_b2.cu).  Every armed instantiation against its plain
     version (every plane word, partial column, witness field and counter)
     and against the unarmed kernel, on N = 1M x 32 fixtures in every
     counts, coin and fault mode and on the fused family, the fused one
     also against the armed two-kernel route; the main path's mode timed
     armed beside unarmed, with its bound, registers, spills and SASS;
     bench.py's flight-recorder regime (balanced f = 0.40, N = 1M x 32,
     max_rounds 64) with the recorder off, on, and with the witness and the
     counters: final states equal, the recorders equal, the recorder and
     witness consistent with the final state, the counters' lanes summing
     to T x N and T x (Np - N) a round, round_history_summary and
     record_overhead_x; packed against unfused; the fused kernel armed at
     N = 8192 x 32 and on an 'at:1:4:amnesia' run; card against CPU at
     8192 x 8 and 16,384 x 4; get_round_history / get_witness through
     ``launch_network`` with poll_rounds, card against CPU;
 12. ``[samplers]``: the histogram path's plain samplers and the omission
     and partition planes, plain torch with no kernel.  Six regimes at
     N = 1M x 32 (max_rounds 64, balanced inputs): bench.py's biased_s0.5
     and biased_s1.5 (f = 0.25; agreement counted, not asserted), the
     uniform scheduler with use_pallas_hist=False, delivery='all' with
     drop_prob 0.05 (F = N/4, no crashes), 'halves:4' (F = N/8, the first
     F crashed) and 'halves:4' with drop_prob 0.05 (no crashes), each with
     its trials/s over simulate, init_state / run_consensus split, rounds,
     decided and disagree fractions, peak memory and the card's line; the
     partition regimes must stall until round 4 and then decide; one
     profiled run of biased_s1.5; the draws on the card against the CPU
     (tables, exact draws and group counts must be equal, the
     normal-quantile draws' differences printed); whole runs at 8192 x 8
     and 16,384 x 4 (every regime, equivocation on the plain sampler,
     strength 1.0), 4096 x 8 (the exact tables) and 1024 x 4 (the dense
     path's partition epoch with omission), card against CPU with the
     first differing round; no kernel may launch in the phase;
 13. ``[topo]``: adjacency topologies, sampled committees and the
     debug callback; no kernel on the structured planes.  The degree
     ladder of the JAX package's science harness (ring:2, ring:4, ring:8,
     torus2d:1000x1000, random_regular:6:1; F = d, zero crashes,
     per-trial random inputs, max_rounds 32), the committee ladder
     (count = cap = 4, sizes N/16, N/8, N/4, F = 1) and the fault mixes
     on ring:8 with F = 8 (byzantine and equivocate with the first 5 %
     faulty, 'halves:4', crash_at_round with the first 5 % dying at round
     2) and a byzantine committee mix, at N = 1M x 16 (half the main
     path's trials, the script's depth cut; the equivocate mix x 8):
     rounds, decided and disagree fractions, the smallest decided k,
     trials/s over simulate and over run_consensus, peak memory;
     ``[breakdown] topo`` of ring:8
     and of the N/8 committee; the same runs at 8192 x 8 (torus2d:64x128)
     card against CPU, every trial and every recorder row equal;
     'complete' equal to no topology; no kernel may launch; then
     debug=True on a packed-eligible config at 8192 x 32: the demotion
     warning, one event a round, the final state and the round kernel
     launches equal to the packed run's;
 14. ``[sweep]``: the sweep engine, its journal and checkpoints.  bench.py's
     north star (five balanced, zero-crash points at N = 1M x 32, the round
     kernels) through one run_points_batched call, five static buckets,
     each point equal to run_point's, with the round kernels' launches;
     bench.py:744-800's batched check (five f values, max_rounds 16, the
     plain CF samplers: one dynamic bucket, no kernel) equal to the
     per-point loop, both wall clocks; both lists in one journaled call
     (six buckets), the journal cut after its third record with half a
     line after it, resumed serially and pipelined: the first three
     buckets restored with no round kernel launched for them, the points
     and journal records equal to the uninterrupted call's; a checkpoint
     of the f = 0.45 run resumed to the uninterrupted run; card against
     CPU at 8192 x 8 on a list mixing a fused static bucket and a dynamic
     bucket, coin_comparison_batched, degree_curve and committee_curve;
 15. ``[science]``: science and the CLI on the card.  ``python -m
     benor_tpu_torch results --n 1000000 --trials 32`` in process (the
     studies and presets, each study's wall time, the round kernels'
     launches, the safety verdicts, the forensics and repros of every
     violating row); generate at N = 400 x 4 card against CPU; the
     atlas's three searches with forensics card against CPU, in band of
     ATLAS_BASELINE.json, ``atlas --searches quorum`` (baseline not
     comparable, exit 0); faults_curves at N = 1M x 32; ``audit`` at
     N = 1M x 32 (0 on crash, 2 on the targeted adversary); the
     baseline's repros through ``replay``; the oracle-parity study's
     lines;
 16. ``[oracle]``: the event-loop oracles, the HTTP node servers and the
     metrics registry.  The native oracle (built with g++ from the
     checkout) equal to the express oracle on tests/test_native_oracle.py's
     seven scenarios in both orders; ``run_batch`` at N = 100 x 256 seeds;
     ``oracle_parity(32)`` on the card, its simulator side's final state
     equal to the CPU's, decided runs order-invariant, the KS statistic
     and p-value; ``serve_network`` over a card ``TpuNetwork`` with the
     flagship flags armed (the CF regime forced), the start.ts demo
     (N = 10, F = 4) and N = 100, F = 30 with ``record=True,
     poll_rounds=1``: every /status and /getState equal to the facade's
     ``get_states`` and to the same launch on the CPU, the
     /getRoundHistory cursor walking every round, POST /message answering
     405, the fused kernel's launches counted; ``trace --device cuda``
     with ``--metrics-out`` (JSON-lines and Prometheus);
 17. ``[profile]``: the performance observatory.  ``profile --device
     cuda`` at N = 1M x 32 x 16 in process (each regime's build, first and
     steady execution, peak memory, device busy share, the port's kernel
     launches and top device entries; the packed loop bit-equal to the
     unfused one and its speedup); ``profile --kernels`` at the capture
     scale, every stage counter equal to the CPU capture's, then at
     N = 8192 x 32 and 1M x 32 (lanes a stage = T x Np x rounds, telemetry
     off == on, each dispatch's device ms a round against its bound); the
     sweep manifest at 9000 x 4 pipelined, card against CPU, telescoping
     in band, one span tree a bucket;
 18. ``[serve]``: the request plane on the card.  ``load --device cuda
     --clients 1000`` in process at DEFAULT_JOB (the committed
     baseline's scale; gated as not comparable, platform gpu): jobs/s,
     p50 / p99, jobs a launch, the attribution coverage, executor builds;
     a ``ServeApp(device='cuda')`` at the default limits, to which a
     simulate at the per-job cap (N = 65,536 x 32, f = 0.45, quorum
     delivery on the histogram path), a sweep over the north star's f
     grid, a trajectory and an audit job are posted over HTTP with SSE,
     each result equal to ``run_point`` of its config on the card (the
     trajectory's round rows to its recorder, the audit's witness rows
     and verdict to the auditor's on that run), then the same four at
     8192 x 8 equal to ``run_point`` on the CPU; a ``ServeApp(limits=...)``
     with n_nodes lifted running 1M x 32 at f = 0.45 (a private
     instance), equal to ``run_point`` on the card; the hand-written
     kernels' launches in the phase (a served job arms no kernel flag);
 19. ``[heartbeat]``: the progress heartbeat.  A 1M x 32 sliced network
     (poll_rounds = 1, heartbeat_rounds = 1, f = 0.45, balanced inputs,
     the flagship flags) against the same run with the heartbeat off:
     final state, rounds and round-kernel launches equal, one beat a round
     and a final one; the north star's six points through
     ``run_points_batched`` with a heartbeat file (five balanced points,
     then the iid crash point), one beat a bucket; ``python -m
     benor_tpu_torch watch --no-follow`` on the file (exit 0); the same
     runs at 8192 x 8 card against CPU, every record equal but its
     clocks;
 20. the kernels line, the card line, and the result line.

It imports nothing of JAX and nothing of the JAX package, and needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# The bound: the card's peaks and the operations the functions need on a
# run's inputs (benor_tpu_torch/perfscope/roofline.py says how each is
# counted).
from benor_tpu_torch.perfscope.roofline import (
    F32_OPS_PER_S, HBM_BYTES_PER_S, OPS_CF_PAIR_LANE, OPS_CF_SAMPLE,
    OPS_CF_TERMS, OPS_CF_TRIAL, OPS_READ_PLANES, OPS_THREEFRY, OPS_UNIFORM,
    ops_needed, ops_quantiles)

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

# Sample sizes a block of cf_counts / equiv_counts tabulates its per-lane
# terms over (csrc/hist_kernels.cu kCfWindow, kEquivWindow).
CF_WINDOW, EQUIV_WINDOW = 2048, 1024


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


def random_pack(cfg, device, seed, balanced=False, faulty_frac=None):
    """A plane stack of a random mid-run state (x, decided, killed, k,
    faulty drawn on the device, one lane in 10 faulty or, with
    ``faulty_frac``, that fraction; with ``balanced`` x alternates 0 and 1
    over the nodes and nodes 2j and 2j + 1 share every other field, so
    that the live and the frozen lanes hold as many 0s as 1s and the
    rounds' tallies tie) -> (pack, its proposal histogram; None under the
    round-bound fault models)."""
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
    if faulty_frac is not None:
        faulty = torch.rand(shape, generator=g, device=device) < faulty_frac
    if balanced:
        node = torch.arange(cfg.n_nodes, device=device)
        x = (node % 2).expand(shape)
        dec, k, killed, faulty = (a[:, node // 2 * 2]
                                  for a in (dec, k, killed, faulty))
    state = NetState(x=x.to(torch.int8), decided=dec,
                     k=k.to(torch.int32), killed=killed)
    pack = pack_state(cfg, state, faulty)
    if cfg.fault_model in ("crash_at_round", "crash_recover"):
        return pack, None           # its histogram needs the round bounds
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
    # the faulty nodes die mid-run (rounds 2 and 3) instead of at birth
    ("crash_at_round", [True] * 4 + [False] * 6, [0, 1] * 5,
     {"fault_model": "crash_at_round", "crash_rounds": [2, 2, 3, 3]
      + [0] * 6}),
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
        elif name == "crash_at_round":
            rounds = nets["cuda"].rounds_executed
            verdict = (reached_finality(live)
                       and len({st["x"] for st in live}) == 1
                       and [st["killed"] for st in states["cuda"]]
                       == [0 < c <= rounds for c in kw["crash_rounds"]])
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
    if cfg.fault_model not in ("crash_at_round", "crash_recover"):
        # a lane of those models may decide before the round it dies in
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
    little).  The pass is perfscope's (``profile_pass``)."""
    from benor_tpu_torch.perfscope.capture import profile_pass

    prof = profile_pass(run, ours=ours, torch_ops=torch_ops)
    busy_ms = prof["busy_us"] / 1e3
    top = ", ".join(f"{k[:60]} {us / 1e3:.3f} ms x{c}"
                    for k, us, c in prof["device"][:8])
    ours_ms = sum(us for _, us, _ in prof["ours"]) / 1e3
    per = ", ".join(f"{k} {us / c / 1e3:.4f} ms a launch x{c}"
                    for k, us, c in prof["ours"])
    if torch_ops:
        top += "; top torch ops by their kernels' device time: " + ", ".join(
            f"{k} {us / 1e3:.3f} ms x{c}" for k, us, c in
            prof["torch_ops"][:10])
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
          f"{time.perf_counter() - t0:.1f} s; nvcc s by source "
          f"{_build.build_seconds(_build.build())}")

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

    # --- 10. crash_at_round and crash_recover in the round kernels ---------
    b2_phase(lib, dev, sms)

    # --- 11. the flight recorder, the witness and the stage counters -------
    kernels.update(obs_phase(lib, dev, sms))

    # --- 12. the plain samplers, omission and partitions (no kernel) -------
    samplers_phase(dev)

    # --- 13. topologies, committees and the debug callback ---------------
    topo_phase(dev)

    # --- 14. the sweep engine, its journal and checkpoints ----------------
    sweep_phase(dev)

    # --- 15. science and the CLI ------------------------------------------
    science_phase(dev)

    # --- 16. the event-loop oracles, the HTTP servers, the registry -------
    oracle_phase(dev)

    # --- 17. the performance observatory ----------------------------------
    profile_phase(dev)

    # --- 18. the request plane -----------------------------------------------
    serve_phase(dev)

    # --- 19. the progress heartbeat ------------------------------------------
    heartbeat_phase(dev)

    # --- 20. the kernels line, the card, the result ------------------------
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


# --- the [b2] phase: crash_at_round and crash_recover in the round kernels --

# the fault models with round bounds and their rejoin modes, and the round
# kernels' counts and coin modes they run under
B2_MODELS = (("crash_at_round", "durable"), ("crash_recover", "durable"),
             ("crash_recover", "amnesia"))
B2_COUNTS = ("sampled", "delivered", "camps")
B2_COINS = ("private", "common", "weak_common")
# the pair's instantiations on N = 1M x 32 fixtures (counts, coin, fault
# model, rejoin), and the fused kernel's on its family (coin, fault model,
# rejoin); each led by the main path's on the same kind of fixture
B2_PAIR = (("sampled", "private", "crash", "durable"),) + tuple(
    (cm, coin, fm, rj) for fm, rj in B2_MODELS for cm in B2_COUNTS
    for coin in B2_COINS)
B2_FUSED = (("private", "crash", "durable"),) + tuple(
    (coin, fm, rj) for fm, rj in B2_MODELS for coin in B2_COINS)
# the pair instantiations whose plain versions are timed as well
B2_PLAIN_TIMED = (("sampled", "private", "crash_at_round", "durable"),
                  ("sampled", "private", "crash_recover", "amnesia"))
B2_FAULTY = 0.45          # the fixtures' faulty fraction
B2_EPS = 0.5              # the weak coin's deviation rate in the fixtures
# the card-vs-CPU sizes (N, T): the fused kernel's, and the pair's
B2_SMALL = ((8192, 8), (16_384, 4))
# a lane's work on its bounds: crash_at_round's two loads' worth of
# compares and the latch; crash_recover's interval, down and latch tests;
# the amnesia test
OPS_BOUNDS = {"crash_at_round": 5, "crash_recover": 12}
OPS_AMNESIA = 7


def b2_bounds(cfg, np_total, fault_model, device, seed):
    """Round bounds for a fixture: crash rounds in {0, 1..6} and recover
    rounds in {0, cr + 1 .. cr + 4} drawn a lane, so that at ROUND = 3
    every class occurs (crashing now, down, never rejoining, rejoining
    now decided and undecided, back, untouched), padded with 0 to the
    plane geometry -> (cr, rcv or None), int32 [T, np_total]."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.trials, cfg.n_nodes)
    cr = torch.randint(0, 7, shape, generator=g, device=device,
                       dtype=torch.int32)
    d = torch.randint(0, 5, shape, generator=g, device=device,
                      dtype=torch.int32)
    rcv = torch.where(d > 0, cr + d, 0).to(torch.int32)

    def pad(a):
        return torch.nn.functional.pad(a, (0, np_total - a.shape[1]))

    return pad(cr), (pad(rcv) if fault_model == "crash_recover" else None)


def b2_classes(pack, cr, rcv, r) -> dict:
    """Faulty lanes of a fixture by their class at round ``r``."""
    from benor_tpu_torch.ops.packed_round import plane_field
    from benor_tpu_torch.state import PACK_DECIDED, PACK_FAULTY
    fau = plane_field(pack, PACK_FAULTY, 1) == 1
    dec = plane_field(pack, PACK_DECIDED, 1) == 1
    started = fau & (cr > 0) & (r >= cr)
    out = {"crashing_now": int((fau & (cr == r)).sum()),
           "started": int(started.sum()),
           "not_yet": int((fau & (cr > r)).sum())}
    if rcv is not None:
        now = fau & (cr > 0) & (rcv == r)
        out.update(never=int((started & (rcv <= 0)).sum()),
                   down=int((started & (rcv > r)).sum()),
                   back=int((started & (rcv > 0) & (rcv < r)).sum()),
                   rejoin_decided=int((now & dec).sum()),
                   rejoin_undecided=int((now & ~dec).sum()))
    return out


def b2_case(cfg, counts_mode, fault_model, rejoin, device, seed,
            balanced=False):
    """A fixture in a mode: a random mid-run pack for ``cfg`` with
    B2_FAULTY of its lanes faulty, its round bounds (``b2_bounds``; none for
    the static models), the proposal histogram of ROUND, the camp bounds,
    the kernels' closed form for the mode and a shared coin bit a trial."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import tally

    sched = {"sampled": "uniform", "delivered": "adversarial",
             "camps": "targeted"}[counts_mode]
    cfg = cfg.replace(scheduler=sched, fault_model=fault_model,
                      delivery="quorum",
                      recovery=(f"at:1:4:{rejoin}"
                                if fault_model == "crash_recover" else None))
    pack, _ = random_pack(cfg, device, seed, balanced, B2_FAULTY)
    cr = rcv = None
    if fault_model in pr.FAULT_ROUNDS:
        cr, rcv = b2_bounds(cfg, pack.shape[2] * 32, fault_model, device,
                            seed + 1)
    hist1 = pr.sent_hist_from_pack(cfg, pack, cr, rcv, ROUND)
    camps = (tally.targeted_camp_bounds(cfg) if counts_mode == "camps"
             else (0, 0))

    def counts(h):
        if counts_mode == "delivered":
            return tally.adversarial_counts(h, cfg.quorum)
        if counts_mode == "camps":
            return tally.targeted_camp_triples(cfg, h)
        return h

    g = torch.Generator(device=device).manual_seed(seed + 2)
    shared = torch.randint(0, 2, (cfg.trials,), generator=g, device=device,
                           dtype=torch.int32)
    bounds = dict(crash_round=cr, recover_round=rcv, rejoin=rejoin)
    return dict(cfg=cfg, pack=pack, hist1=hist1, camps=camps, counts=counts,
                shared=shared, bounds=bounds)


def b2_needs(pack, new_pack, counts_mode, m, hists, qok) -> dict:
    """``mode_needs`` of a B2 fixture: the lanes the round's bounds leave
    dead or down this round (the new stack's killed and down planes) read
    no draw."""
    from benor_tpu_torch.state import PACK_DOWN, PACK_KILLED
    adj = pack.clone()
    adj[:, PACK_KILLED] = new_pack[:, PACK_KILLED] | new_pack[:, PACK_DOWN]
    return mode_needs(adj, counts_mode, False, m, hists, qok, new_pack)


def b2_pair(lib, cfg, counts_mode, coin_mode, fault_model, rejoin, device,
            seed) -> dict:
    """proposal_hist and vote_commit in one mode against their plain
    versions on a random N = 1M x 32 fixture (``b2_case``; the vote on the
    proposal's gate and on a balanced histogram of its voters, so that
    lanes coin), every count and plane word (killed and down included),
    then three timed repeats of each launch -> dict."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal
    from benor_tpu_torch.state import PACK_K

    case = b2_case(cfg, counts_mode, fault_model, rejoin, device, seed)
    cfg, pack, bnd = case["cfg"], case["pack"], case["bounds"]
    m, r = cfg.quorum, ROUND
    t, planes, n_w = pack.shape
    lanes = t * n_w * 32
    eps = B2_EPS if coin_mode == "weak_common" else 0.0
    tag = f"{counts_mode}/{coin_mode}/{fault_model}/{rejoin}"
    pm = dict(fault_model=fault_model, freeze=True, counts_mode=counts_mode,
              camp_b0=case["camps"][0], camp_b1=case["camps"][1], **bnd)
    vm = dict(pm, coin_mode=coin_mode, eps=eps, shared=case["shared"])
    c1 = case["counts"](case["hist1"])
    parts_k = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, c1, pack, m,
                               **pm)
    parts_p = pr.proposal_hist_plain(SEED, r, rng.PHASE_PROPOSAL, c1, pack,
                                     m, **pm)
    torch.cuda.synchronize()
    res_p = compare(f"proposal_hist {tag}", lanes, [(parts_k, parts_p)])
    qok = parts_p[:, 3] >= m
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
    needs = b2_needs(pack, new_p, counts_mode, m, (c1, c2), qok)
    classes = (b2_classes(pack, bnd["crash_round"], bnd["recover_round"], r)
               if bnd["crash_round"] is not None else {})
    if classes and not all(classes.values()):
        raise SystemExit(f"{tag}: a class of lanes is missing: {classes}")
    if coin_mode != "private" and not needs["coins"]:
        raise SystemExit(f"{tag}: the fixture coined no lane")
    del new_k, new_p

    hist_f1, hist_f2 = (pr.kernel_vecs(c, counts_mode) for c in (c1, c2))
    qok_i = qok.to(torch.int32).contiguous()
    shared_i = None if coin_mode == "private" else case["shared"]
    ops_b = pr._bounds_operands(fault_model, bnd["crash_round"],
                                bnd["recover_round"], rejoin, pack)
    calls = {
        "proposal_hist": lambda: pr._launch_proposal_hist(
            lib, stream_scal(SEED, r, rng.PHASE_PROPOSAL), hist_f1, pack, m,
            fault_model, True, counts_mode, (0, 0), None, case["camps"], r,
            ops_b),
        "vote_commit": lambda: pr._launch_vote_commit(
            lib, stream_scal(SEED, r, rng.PHASE_VOTE),
            stream_scal(SEED, r, _COIN_SALT), r + 1, hist_f2, qok_i, pack,
            m, cfg.n_faulty, "reference", fault_model, True, counts_mode,
            coin_mode, (0, 0), None, shared_i, eps, case["camps"], ops_b),
    }
    ms = {k: repeats(fn) for k, fn in calls.items()}
    fault = pr.FAULT_ROUNDS.get(fault_model, 0)
    op_bytes = sum(a.numel() * 4 for a in ops_b[:2] if a is not None)
    nvec = hist_f1.shape[1]
    bytes_ = {
        "proposal_hist": pack.numel() * 4 + op_bytes + t * nvec * 4
        + pr.round_blocks(lib, 0, n_w, t, device,
                          pr._mode_ids(counts_mode, "private", fault_model),
                          fault) * t * pr.PROP_COLS * 4,
        "vote_commit": 2 * pack.numel() * 4 + op_bytes + t * (nvec + 2) * 4
        + pr.round_blocks(lib, 1, n_w, t, device,
                          pr._mode_ids(counts_mode, coin_mode, fault_model),
                          fault) * t * pr.VOTE_COLS * 4,
    }
    per_lane = OPS_BOUNDS.get(fault_model, 0) + (
        OPS_AMNESIA if ops_b[2] else 0)
    ops = {k: mode_ops(k, lanes, t, n_w * t, planes - PACK_K, counts_mode,
                       coin_mode, False, needs[f"{p}_draws"],
                       needs[f"{p}_tails"], needs[f"{p}_sizes"],
                       needs["coins"]) + lanes * per_lane
           for k, p in (("proposal_hist", "proposal"),
                        ("vote_commit", "vote"))}
    plain = {}
    if (counts_mode, coin_mode, fault_model, rejoin) in B2_PLAIN_TIMED:
        plain = {
            "proposal_hist": cuda_ms(lambda: pr.proposal_hist_plain(
                SEED, r, rng.PHASE_PROPOSAL, c1, pack, m, **pm), 3),
            "vote_commit": cuda_ms(lambda: pr.vote_commit_plain(
                SEED, r, rng.PHASE_VOTE, c2, pack, qok, **vote, **vm), 3)}
    print(f"[fixture] b2 {tag}: lanes {lanes}, faulty lanes by class at "
          f"round {r} {classes}, needs {needs}; kernel ms {ms}; plain ms "
          f"{plain or 'not timed'}")
    return dict(res=(res_p, res_v), ms=ms, needs=needs, bytes=bytes_,
                ops=ops, calls=calls, tag=tag, plain=plain)


def b2_fused(lib, trials, n, coin_mode, fault_model, rejoin, device,
             timed) -> dict:
    """fused_round in one mode on a balanced B2 fixture of ``trials`` x
    ``n`` (the textbook rule, so that the active lanes coin) against its
    plain version and the two-kernel route, bit for bit; with ``timed``
    three timed repeats of its launch, as every kernel is and queued."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.state import PACK_COINED, PACK_K

    cfg = main_cfg().replace(n_nodes=n, n_faulty=int(0.4 * n),
                             trials=trials)
    case = b2_case(cfg, "sampled", fault_model, rejoin, device, SEED + 5,
                   balanced=True)
    cfg, pack, hist, bnd = (case["cfg"], case["pack"], case["hist1"],
                            case["bounds"])
    m, r = cfg.quorum, ROUND
    lanes = trials * pack.shape[2] * 32
    eps = B2_EPS if coin_mode == "weak_common" else 0.0
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="textbook",
                fault_model=fault_model, freeze=True)
    modes = dict(coin_mode=coin_mode, eps=eps, shared=case["shared"], **bnd)
    out_k = pr.fused_round(SEED, r, hist, pack, **vote, **modes)
    out_p = pr.fused_round_plain(SEED, r, hist, pack, **vote, **modes)
    parts_a = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist, pack, m,
                               fault_model, True, **bnd)
    new_2, parts_b = pr.vote_commit(SEED, r, rng.PHASE_VOTE, parts_a[:, :3],
                                    pack, parts_a[:, 3] >= m, **vote,
                                    **modes)
    torch.cuda.synchronize()
    tag = f"{coin_mode}/{fault_model}/{rejoin} T={trials} N={n}"
    res = compare(f"fused_round {tag}", lanes, list(zip(out_k, out_p)))
    same = all(torch.equal(a, b)
               for a, b in zip(out_k, (new_2, parts_a, parts_b)))
    print(f"[dispatch] b2 fused_round vs proposal_hist + sum + vote_commit "
          f"at {tag}: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"fused and two-kernel rounds differ at {tag}")
    if not int(pr.plane_field(out_p[0], PACK_COINED, 1).sum()) and n >= 1024:
        raise SystemExit(f"{tag}: the fixture coined no lane")
    fault = pr.FAULT_ROUNDS.get(fault_model, 0)
    out = dict(res=res, lanes=lanes, grid=pr.fused_grid(
        lib, pack.shape[2], trials, device, coin_mode, False, fault))
    if timed:
        def fused():
            return pr.fused_round(SEED, r, hist, pack, **vote, **modes)
        out["ms"] = repeats(fused)
        out["ms_queued"] = repeats(fused, queued=True)
        out["plain_ms"] = cuda_ms(lambda: pr.fused_round_plain(
            SEED, r, hist, pack, **vote, **modes), 3)
        op_bytes = sum(a.numel() * 4 for a in (bnd["crash_round"],
                                               bnd["recover_round"])
                       if a is not None)
        out["bytes"] = 2 * pack.numel() * 4 + op_bytes + trials * 3 * 4 \
            + trials * (pr.PROP_COLS + pr.VOTE_COLS) * 4
        nd = b2_needs(pack, out_p[0], "sampled", m, (hist, out_p[1][:, :3]),
                      out_p[1][:, 3] >= m)
        t, planes, n_w = pack.shape
        per_lane = OPS_BOUNDS.get(fault_model, 0) + (
            OPS_AMNESIA if fault == 2 and rejoin == "amnesia" else 0)
        out["needs"] = nd
        out["ops"] = lanes * per_lane + sum(
            mode_ops(k, lanes, t, n_w * t, planes - PACK_K, "sampled",
                     coin_mode, False, nd[f"{p}_draws"], nd[f"{p}_tails"],
                     nd[f"{p}_sizes"], nd["coins"])
            for k, p in (("proposal_hist", "proposal"),
                         ("vote_commit", "vote")))
    return out


def b2_regimes(n, trials, max_rounds=MAX_ROUNDS, device="cuda"):
    """The [b2] regimes at ``n`` x ``trials`` on balanced inputs, the
    uniform scheduler's quorum delivery on the histogram path ->
    [(name, cfg, inputs, faults)]: the first F = 0.45 N lanes crash at
    round 2 (crash_at_round, ``crash_rounds``); crash_recover's 'at:1:4'
    durable and amnesia at F = 0.45 N; 'stagger:1:4:amnesia' at
    F = 0.25 N (bench.py:1667-1671's schedule); 'at:2:0', which never
    rejoins and equals the first."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.faults import crash_recover_faults
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs

    base = {**MAIN_RUN, "trials": trials, "max_rounds": max_rounds}
    bal = balanced_inputs(trials, n)
    f45 = int(0.45 * n)
    c = SimConfig(n_nodes=n, n_faulty=f45,
                  **{**base, "fault_model": "crash_at_round"})
    out = [("crash_at_round_f0.45", c, bal, FaultSpec.first_f(
        c, crash_rounds=[2] * f45 + [0] * (n - f45), device=device))]
    for name, spec, f in (("recover_at1_4_f0.45", "at:1:4", f45),
                          ("recover_at1_4_amnesia_f0.45", "at:1:4:amnesia",
                           f45),
                          ("recover_stagger1_4_amnesia_f0.25",
                           "stagger:1:4:amnesia", int(0.25 * n)),
                          ("recover_at2_0_f0.45", "at:2:0", f45)):
        c = SimConfig(n_nodes=n, n_faulty=f, recovery=spec,
                      **{**base, "fault_model": "crash_recover"})
        out.append((name, c, bal, crash_recover_faults(c, device)))
    return out


def b2_small_extra(n, trials, device="cuda"):
    """The other mode combinations for the card-vs-CPU runs: the amnesia
    rejoin under the common and the weak coin, crash_at_round under the
    adversarial scheduler (delivered counts, the common coin) and the
    amnesia rejoin under the targeted adversary (camps)."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.faults import crash_recover_faults
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs

    base = {**MAIN_RUN, "trials": trials}
    bal = balanced_inputs(trials, n)
    f = int(0.4 * n)
    f += (n - f) % 2                   # an even quorum, as bench.py's
    out = []
    for name, kw in (("recover_amnesia_common",
                      dict(coin_mode="common")),
                     ("recover_amnesia_weak",
                      dict(coin_mode="weak_common", coin_eps=B2_EPS)),
                     ("recover_amnesia_targeted",
                      dict(scheduler="targeted", max_rounds=16,
                           use_pallas_hist=False))):
        c = SimConfig(n_nodes=n, n_faulty=f, recovery="at:1:3:amnesia",
                      **{**base, "fault_model": "crash_recover", **kw})
        out.append((name, c, bal, crash_recover_faults(c, device)))
    c = SimConfig(n_nodes=n, n_faulty=f, coin_mode="common",
                  **{**base, "fault_model": "crash_at_round",
                     "scheduler": "adversarial"})
    out.append(("crash_at_adversarial_common", c, bal, FaultSpec.first_f(
        c, crash_rounds=[2] * f + [0] * (n - f), device=device)))
    return out


def b2_phase(lib, dev, sms) -> None:
    """The [b2] phase (see the module docstring): crash_at_round and
    crash_recover in the round kernels.  Every new instantiation against
    its plain version and timed, with its bound and resources; the five
    regimes at N = 1M x 32 on the round kernels; the N = 8192 runs on the
    fused kernel alone; the split and a profiled run; packed against
    unfused; card against CPU.  Any differing word, count or run raises
    SystemExit."""
    import torch
    from benor_tpu_torch import simulate
    from benor_tpu_torch.ops import _build, sass
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import init_state

    t_phase = time.perf_counter()
    cfg = main_cfg().replace(n_faulty=int(0.4 * N_MAIN))

    def bound(nbytes, ops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    # 1. every new instantiation of the pair on N = 1M x 32, timed once (a
    # proposal instantiation under each rejoin mode, whatever the coin)
    held, timed, pair_calls = set(), set(), {}
    for i, (cm, coin, fm, rj) in enumerate(B2_PAIR):
        res = b2_pair(lib, cfg, cm, coin, fm, rj, dev, SEED + 40 + i)
        counts, coin_id, _, _ = pr._mode_ids(cm, coin, fm)
        fault = pr.FAULT_ROUNDS.get(fm, 0)
        insts = {"proposal_hist": sass.mode_label(
                     "proposal_hist_kernel", (counts, 0, fault)),
                 "vote_commit": sass.mode_label(
                     "vote_commit_kernel", (counts, coin_id, 0, fault))}
        for k, inst in insts.items():
            held.add(inst)
            if (inst, rj) in timed:
                continue
            timed.add((inst, rj))
            pair_calls.setdefault(inst, res["calls"][k])
            b_ms, by = bound(res["bytes"][k], res["ops"][k])
            med = median(res["ms"][k])
            ctl = "" if "<" in inst else " control"
            plain = res["plain"].get(k)
            plain = "" if plain is None else f", plain {plain:.4f} ms"
            print(f"[time] b2{ctl} {inst} ({res['tag']}): kernel "
                  f"{res['ms'][k]} ms (median {med:.4f}){plain}, bound "
                  f"{b_ms:.4f} ms ({by}; bytes {res['bytes'][k]} B, "
                  f"operations {res['ops'][k]} needed), share "
                  f"{b_ms / med:.3f}; library null")
        del res
        torch.cuda.empty_cache()

    # 2. every new instantiation of the fused kernel on its shape family,
    # timed at its cap N = 8192 x 32
    for coin, fm, rj in B2_FUSED:
        fault = pr.FAULT_ROUNDS.get(fm, 0)
        for t_f, n_f in FUSED_FAMILY:
            f = b2_fused(lib, t_f, n_f, coin, fm, rj, dev,
                         (t_f, n_f) == FUSED_FAMILY[0])
            inst = sass.mode_label("fused_cluster_kernel" if f["grid"][0] > 1
                                   else "fused_round_kernel",
                                   (pr.COIN_MODES.index(coin), 0, fault))
            held.add(inst)
            if "ms" not in f:
                continue
            b_ms, by = bound(f["bytes"], f["ops"])
            ctl = "" if "<" in inst else " control"
            print(f"[time] b2{ctl} {inst} ({coin}/{fm}/{rj}, T={t_f} "
                  f"N={n_f}, grid {f['grid']}, needs {f['needs']}): fused "
                  f"wrapper {f['ms']} ms (median {median(f['ms']):.4f}), "
                  f"queued {f['ms_queued']} ms (median "
                  f"{median(f['ms_queued']):.4f}), plain "
                  f"{f['plain_ms']:.4f} ms; bound {b_ms:.5f} ms "
                  f"({by}; bytes {f['bytes']} B, operations {f['ops']} "
                  f"needed), share queued "
                  f"{b_ms / median(f['ms_queued']):.3f}; library null")

    # 3. their registers, spills and SASS (csrc/round_b2.cu), at the clock
    # read while the first crash_recover vote instantiation runs
    b2_res = sass.resource_report(_build.CSRC / "round_b2.cu",
                                  _build.BUILD_DIR)
    mhz = clock_during(next(v for k, v in pair_calls.items()
                            if k.startswith("vote_commit_kernel<")
                            and "recover" in k))
    sass.print_resources("b2", {k: v for k, v in b2_res.items()
                                if not k.startswith("fused")},
                         TRIALS * N_MAIN, sms, mhz)
    sass.print_resources("b2", {k: v for k, v in b2_res.items()
                                if k.startswith("fused")},
                         TRIALS * N_FUSED, sms, mhz)
    spills = {k: (v.get("spill_stores"), v.get("spill_loads"))
              for k, v in b2_res.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    untried = sorted(set(b2_res) - held)
    if untried or not b2_res:
        raise SystemExit(f"[b2] instantiations never held against their "
                         f"plain versions: {untried or 'none built'}")
    print(f"[ptxas] b2: {len(b2_res)} new instantiations, clocks.sm "
          f"{mhz:.0f} MHz; spilling: {spills or 'none'}")

    # 4. the regimes at N = 1M x 32 on the round kernels
    regimes = b2_regimes(N_MAIN, TRIALS, device=dev)
    kept = {}
    pr.reset_launches()
    hk.reset_launches()
    for name, c, vals, fl in regimes:
        before = {k: fn.launches for k, fn in pr.KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        split = check_final(c, rounds, fin)
        dec = float(fin.decided.float().mean())
        grown = {k: fn.launches - before[k] for k, fn in pr.KERNELS.items()}
        print(f"[b2] {name}: N={c.n_nodes} F={c.n_faulty} T={c.trials} "
              f"recovery {c.recovery}: rounds {rounds} decided {dec:.6f} "
              f"disagreeing trials {split} killed "
              f"{int(fin.killed.sum())} simulate {sec:.4f} s trials/s "
              f"{c.trials / sec:.3f}; launches {grown}")
        if not grown["vote_commit"] or grown["vote_commit"] != rounds:
            raise SystemExit(f"{name}: not one round kernel pair a round")
        if "at1_4" in name or "stagger" in name:
            if rounds < 5:       # a down lane is unsettled until it rejoins
                raise SystemExit(f"{name}: ended before the rejoin round")
        kept[name] = (rounds, fin)
    launched = {k: fn.launches for k, fn in (*pr.KERNELS.items(),
                                             *hk.KERNELS.items())}
    print(f"[b2] launches {launched}")
    if not (launched["proposal_hist"] and launched["vote_commit"]):
        raise SystemExit("[b2] the pair never launched")
    if any(fn.launches for fn in hk.KERNELS.values()):
        raise SystemExit("[b2] a histogram kernel ran on the packed path")
    (ra, fa), (rb, fb) = (kept.pop("crash_at_round_f0.45"),
                          kept.pop("recover_at2_0_f0.45"))
    diff = trials_differing(fa, fb)
    print(f"[b2] recover_at2_0_f0.45 vs crash_at_round_f0.45: rounds {rb} "
          f"vs {ra}, trials differing {diff} of {TRIALS}")
    if ra != rb or diff:
        raise SystemExit("[b2] 'at:2:0' differs from crash_at_round")
    del fa, fb

    # 5. N = 8192 runs: the fused kernel alone, one launch a round
    for t_f in (TRIALS, 1):
        (_, c, vals, fl), = [x for x in b2_regimes(N_FUSED, t_f, device=dev)
                             if x[0] == "recover_at1_4_amnesia_f0.45"]
        before = {k: fn.launches for k, fn in pr.KERNELS.items()}
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        check_final(c, rounds, fin)
        grown = {k: fn.launches - before[k] for k, fn in pr.KERNELS.items()}
        print(f"[b2] fused recover_at1_4_amnesia N={N_FUSED} T={t_f}: "
              f"rounds {rounds}, launches {grown}")
        if grown != {"proposal_hist": 0, "vote_commit": 0,
                     "fused_round": rounds} or rounds < 5:
            raise SystemExit("[b2] the N = 8192 run is not one fused_round "
                             "launch a round to the rejoin")

    # 6. where the time goes: the split, the per-round histogram alone,
    # one profiled run
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
        print(f"[b2] split {name}: init_state {t_init:.4f} s, "
              f"run_consensus {t_run:.4f} s ({rounds} rounds, "
              f"{c.trials / t_run:.3f} trials/s over run_consensus alone)")
    name, c, vals, fl = regimes[2]            # at:1:4:amnesia
    st = init_state(c, vals, fl)
    pack = pr.pack_state(c, st, fl.faulty)
    bnd = pr.pad_fault_rounds(c, fl, pack.shape[2] * 32)
    ms_hist = cuda_ms(lambda: pr.sent_hist_from_pack(c, pack, *bnd, 5), 5)
    ms_pack = cuda_ms(lambda: pr.pack_state(c, st, fl.faulty), 5)
    ms_unpack = cuda_ms(lambda: pr.unpack_state(pack, N_MAIN), 5)
    print(f"[parts] b2 {name}: sent_hist_from_pack {ms_hist:.3f} ms a "
          f"round (x {kept[name][0]} rounds), pack_state {ms_pack:.3f} ms "
          f"and unpack_state {ms_unpack:.3f} ms a run; run_consensus "
          f"{t_runs[name] * 1e3:.3f} ms")
    del pack, bnd
    breakdown("b2", name, lambda: run_consensus(c, st, fl), t_runs[name],
              tuple(pr.KERNELS), torch_ops=True)
    del st

    # 7. packed against unfused at N = 1M x 32
    for name in ("recover_at1_4_f0.45", "recover_at1_4_amnesia_f0.45"):
        (_, c, vals, fl), = [x for x in regimes if x[0] == name]
        p_rounds, p_fin = kept.pop(name)
        rounds, fin, _ = simulate(c.replace(use_pallas_round=False), vals,
                                  faults=fl, device="cuda")
        diff = trials_differing(fin, p_fin)
        print(f"[b2] {name} unfused vs packed: rounds {rounds} vs "
              f"{p_rounds}, trials differing {diff} of {c.trials}")
        if rounds != p_rounds or diff:
            raise SystemExit(f"{name}: unfused and packed runs differ")
        del fin, p_fin
    del regimes, kept
    torch.cuda.empty_cache()

    # 8. the card against the CPU at small sizes: every mode combination
    for n_s, t_s in B2_SMALL:
        for d_runs in zip(b2_regimes(n_s, t_s, device="cuda")
                          + b2_small_extra(n_s, t_s, "cuda"),
                          b2_regimes(n_s, t_s, device="cpu")
                          + b2_small_extra(n_s, t_s, "cpu")):
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
            print(f"[b2] card vs cpu {name} N={n_s} T={t_s}: rounds cuda "
                  f"{rg} cpu {rc}, trials differing {diff} of {t_s} (cpu "
                  f"{tc:.2f} s, card {tg:.3f} s); card launches {grown}")
            if rg != rc or diff:
                raise SystemExit(f"[b2] {name} N={n_s}: card and CPU runs "
                                 "disagree")
            if not any(grown.values()) or pr.fused_one_pass_eligible(
                    c, t_s, n_s) != bool(grown["fused_round"]):
                raise SystemExit(f"[b2] {name} N={n_s}: dispatch")
    print(f"[b2] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [obs] phase: the flight recorder, the witness and the stage
# counters in the round kernels' armed twins ---------------------------------

# the fault models the armed twins are held under (with their rejoin), and
# the fixtures that cover every armed instantiation: the pair's on
# N = 1M x 32 (counts, coin, fault model, rejoin), the fused kernel's on its
# shape family (coin, fault model, rejoin); each list led by the main
# path's mode
OBS_MODELS = (("crash", "durable"), ("equivocate", "durable"),
              ("crash_at_round", "durable"), ("crash_recover", "amnesia"))
OBS_PAIR = tuple((cm, coin, fm, rj) for fm, rj in OBS_MODELS
                 for cm in B2_COUNTS for coin in B2_COINS)
OBS_FUSED = tuple((coin, fm, rj) for fm, rj in OBS_MODELS
                  for coin in B2_COINS)
OBS_WITNESS = 16          # watched nodes: WITNESS_MAX_NODES
OBS_TRIALS = (0, 1, 2, 3)  # bench.py's default_witness_overrides
OBS_SMALL = ((8192, 8), (16_384, 4))
# the card-vs-CPU regimes (item8_regimes / b2_regimes by name)
OBS_SMALL_RUNS = ("adv_common", "targeted_f0.25", "weak_eps0.55",
                  "equiv_uniform_f0.20", "crash_at_round_f0.45",
                  "recover_at1_4_amnesia_f0.45")
# The armed twins' work beyond the unarmed pass, as this run's data needs
# it: a witness field of a watched lane (T x k of them) its cast and store
# (1); the margin on an active lane (the vote's tally lanes of ``needs``)
# subtract, abs, cast and max (4); a plane word's recorder sums (six) and
# stage counters (one in the proposal pass, three in the vote pass) a mask
# of its planes, a popcount and an add (3 each).
OPS_WITNESS_FIELD = 1
OPS_MARGIN = 4
OPS_WORD_COUNT = 3
OBS_FIELDS = {"proposal_hist": 2, "vote_commit": 6}
OBS_WORD_COUNTS = {"proposal_hist": 1, "vote_commit": 6 + 3}


def obs_ops(kernel, trials, k, words, active) -> int:
    """Operations an armed pass needs beyond its unarmed pass (record, ``k``
    watched nodes and the stage counters) on ``words`` plane words with
    ``active`` active lanes, ``trials`` trials."""
    ops = (trials * k * OBS_FIELDS[kernel] * OPS_WITNESS_FIELD
           + words * OBS_WORD_COUNTS[kernel] * OPS_WORD_COUNT)
    if kernel == "vote_commit":
        ops += active * OPS_MARGIN
    return ops


def obs_ids(n, k=OBS_WITNESS):
    """The watched global node ids of ``k`` nodes out of ``n``
    (state.witness_node_ids)."""
    k = min(k, n)
    lo = (k + 1) // 2
    return tuple(range(lo)) + tuple(range(n - (k - lo), n))


def obs_case(cfg, counts_mode, fault_model, rejoin, device, seed,
             balanced=False):
    """A fixture in a mode for the armed twins: ``b2_case``'s under the
    round-bound models, ``mode_case``'s (live equivocators counted) under
    the static ones, with the bounds and n_equiv keys both give."""
    if fault_model in ("crash_at_round", "crash_recover"):
        case = b2_case(cfg, counts_mode, fault_model, rejoin, device, seed,
                       balanced)
        case["n_equiv"] = None
        return case
    case = mode_case(cfg, counts_mode, fault_model, device, seed, balanced)
    case["bounds"] = dict(crash_round=None, recover_round=None,
                          rejoin="durable")
    return case


def obs_pair(lib, cfg, counts_mode, coin_mode, fault_model, rejoin, device,
             seed, timed=False) -> dict:
    """proposal_hist and vote_commit's armed twins in one mode (the
    recorder's columns, 16 watched nodes, the stage counters) against their
    plain versions on a random N = 1M x 32 fixture, every count, plane
    word, witness field and counter, and against the unarmed kernels on the
    outputs both give; with ``timed``, three timed repeats of each armed
    launch and of the unarmed one beside it -> dict."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.ops.stream import _COIN_SALT, stream_scal
    from benor_tpu_torch.state import PACK_K

    case = obs_case(cfg, counts_mode, fault_model, rejoin, device, seed)
    cfg, pack, bnd = case["cfg"], case["pack"], case["bounds"]
    m, r, n = cfg.quorum, ROUND, cfg.n_nodes
    t, planes, n_w = pack.shape
    lanes = t * n_w * 32
    eps = B2_EPS if coin_mode == "weak_common" else 0.0
    tag = f"{counts_mode}/{coin_mode}/{fault_model}/{rejoin}"
    wids = obs_ids(n)
    obs = dict(witness_ids=wids, n_local=n)
    tiles = n_w * 32 // pr.TILE_N

    def acc():
        """A stage's counter accumulator, zeroed."""
        return torch.zeros((tiles, pr.TELEM_WIDTH), dtype=torch.int32,
                           device=device)

    pm = dict(fault_model=fault_model, freeze=True,
              n_equiv=case["n_equiv"], counts_mode=counts_mode,
              camp_b0=case["camps"][0], camp_b1=case["camps"][1], **bnd)
    vm = dict(pm, coin_mode=coin_mode, eps=eps, shared=case["shared"])
    c1 = case["counts"](case["hist1"])
    args_p = (SEED, r, rng.PHASE_PROPOSAL, c1, pack, m)
    tel_k, tel_p = acc(), acc()
    out_k = pr.proposal_hist(*args_p, **pm, **obs, telemetry=tel_k)
    out_p = pr.proposal_hist_plain(*args_p, **pm, **obs, telemetry=tel_p)
    unarmed = pr.proposal_hist(*args_p, **pm)
    torch.cuda.synchronize()
    res_p = compare(f"proposal_hist armed {tag}", lanes,
                    [(out_k, out_p), (tel_k, tel_p),
                     (out_k[:, :pr.PROP_COLS], unarmed)])
    qok = out_p[:, 3] >= m
    tot = out_p[:, :3].sum(1)
    c2 = case["counts"](torch.stack([tot // 2, tot - tot // 2, tot * 0],
                                    dim=1))
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="reference")
    args_v = (SEED, r, rng.PHASE_VOTE, c2, pack, qok)
    tel_k, tel_p = acc(), acc()
    vout_k = pr.vote_commit(*args_v, **vote, **vm, record=True, **obs,
                            telemetry=tel_k)
    vout_p = pr.vote_commit_plain(*args_v, **vote, **vm, record=True, **obs,
                                  telemetry=tel_p)
    vun = pr.vote_commit(*args_v, **vote, **vm)
    torch.cuda.synchronize()
    res_v = compare(f"vote_commit armed {tag}", lanes,
                    list(zip(vout_k, vout_p)) + [(tel_k, tel_p)]
                    + [(vout_k[0], vun[0]),
                       (vout_k[1][:, :pr.VOTE_COLS], vun[1])])
    witnessed = int((vout_p[1][:, pr.VOTE_OBS_COLS:] != 0).sum())
    out = dict(res=(res_p, res_v), tag=tag, witnessed=witnessed,
               margin=vout_p[1][:, 11].tolist()[:4])
    if not timed:
        return out

    # the launches alone, armed and unarmed, on the same operands
    hist_f1, hist_f2 = (pr.kernel_vecs(c, counts_mode) for c in (c1, c2))
    qok_i = qok.to(torch.int32).contiguous()
    shared_i = None if coin_mode == "private" else case["shared"]
    ops_b = pr._bounds_operands(fault_model, bnd["crash_round"],
                                bnd["recover_round"], rejoin, pack)
    key2, ne_f = pr._equiv_operands(SEED, r, rng.PHASE_PROPOSAL,
                                    case["n_equiv"], fault_model,
                                    counts_mode, t, device)
    vkey2, _ = pr._equiv_operands(SEED, r, rng.PHASE_VOTE, case["n_equiv"],
                                  fault_model, counts_mode, t, device)
    # each Obs points into the tensors beside it, which the calls keep alive
    tel_p, tel_v = acc(), acc()
    ops_p = (*pr._obs_operands(t, device, wids, n, tel_p), tel_p)
    ops_v = (*pr._obs_operands(t, device, wids, n, tel_v), tel_v)
    ops_r = pr._obs_operands(t, device, (), n)      # the recorder alone

    def prop(o=None):
        return pr._launch_proposal_hist(
            lib, stream_scal(SEED, r, rng.PHASE_PROPOSAL), hist_f1, pack, m,
            fault_model, True, counts_mode, key2, ne_f, case["camps"], r,
            ops_b, obs=o)

    def vote_(o=None):
        return pr._launch_vote_commit(
            lib, stream_scal(SEED, r, rng.PHASE_VOTE),
            stream_scal(SEED, r, _COIN_SALT), r + 1, hist_f2, qok_i, pack, m,
            cfg.n_faulty, "reference", fault_model, True, counts_mode,
            coin_mode, vkey2, ne_f, shared_i, eps, case["camps"], ops_b,
            obs=o)

    calls = {"proposal_hist": lambda: (prop(ops_p[0]), ops_p),
             "vote_commit": lambda: (vote_(ops_v[0]), ops_v)}
    ms = {k: repeats(fn) for k, fn in calls.items()}
    ms_unarmed = {"proposal_hist": repeats(prop), "vote_commit": repeats(vote_)}
    ms_record = repeats(lambda: (vote_(ops_r[0]), ops_r))
    plain = {
        "proposal_hist": cuda_ms(lambda: pr.proposal_hist_plain(
            *args_p, **pm, **obs, telemetry=tel_p), 3),
        "vote_commit": cuda_ms(lambda: pr.vote_commit_plain(
            *args_v, **vote, **vm, record=True, **obs, telemetry=tel_v), 3)}
    if fault_model in pr.FAULT_ROUNDS:
        needs = b2_needs(pack, vout_p[0], counts_mode, m, (c1, c2), qok)
    else:
        needs = mode_needs(pack, counts_mode, ne_f is not None, m,
                           (c1, c2), qok, vout_p[0], case["n_equiv"])
    fault = pr.FAULT_ROUNDS.get(fault_model, 0)
    modes_p = pr._mode_ids(counts_mode, "private", fault_model)
    modes_v = pr._mode_ids(counts_mode, coin_mode, fault_model)
    op_bytes = sum(a.numel() * 4 for a in ops_b[:2] if a is not None)
    nvec = hist_f1.shape[1]
    k = len(wids)
    bytes_ = {
        "proposal_hist": pack.numel() * 4 + op_bytes + t * nvec * 4
        + pr.round_blocks(lib, 0, n_w, t, device, modes_p, fault, True)
        * t * pr.PROP_COLS * 4 + t * k * 2 * 4 + tiles * pr.TELEM_WIDTH * 4,
        "vote_commit": 2 * pack.numel() * 4 + op_bytes + t * (nvec + 2) * 4
        + pr.round_blocks(lib, 1, n_w, t, device, modes_v, fault, True)
        * t * pr.VOTE_OBS_COLS * 4 + t * k * 6 * 4
        + tiles * pr.TELEM_WIDTH * 4,
    }
    per_lane = OPS_BOUNDS.get(fault_model, 0) + (
        OPS_AMNESIA if ops_b[2] else 0)
    ops = {kk: mode_ops(kk, lanes, t, n_w * t, planes - PACK_K, counts_mode,
                        coin_mode, ne_f is not None, needs[f"{p}_draws"],
                        needs[f"{p}_tails"], needs[f"{p}_sizes"],
                        needs["coins"])
           + lanes * per_lane
           + obs_ops(kk, t, k, n_w * t, needs["vote_draws"])
           for kk, p in (("proposal_hist", "proposal"),
                         ("vote_commit", "vote"))}
    print(f"[fixture] obs {tag}: lanes {lanes}, needs {needs}; armed ms "
          f"{ms}; unarmed ms {ms_unarmed}; vote_commit armed with the "
          f"recorder alone (no witness, no counters) {ms_record} ms (median "
          f"{median(ms_record):.4f}); plain armed ms {plain}")
    out.update(ms=ms, ms_unarmed=ms_unarmed, plain=plain, bytes=bytes_,
               ops=ops, calls=calls, needs=needs)
    return out


def obs_fused(lib, trials, n, coin_mode, fault_model, rejoin, device,
              timed) -> dict:
    """fused_round's armed twin in one mode on a balanced fixture of
    ``trials`` x ``n`` (the textbook rule, so that active lanes coin)
    against its plain version, the unarmed kernel and the armed two-kernel
    route, bit for bit; with ``timed`` three timed repeats of the armed and
    the unarmed launch, queued as well."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import rng
    from benor_tpu_torch.state import PACK_K

    cfg = main_cfg().replace(n_nodes=n, n_faulty=int(0.4 * n),
                             trials=trials)
    case = obs_case(cfg, "sampled", fault_model, rejoin, device, SEED + 7,
                    balanced=True)
    cfg, pack, hist, bnd = (case["cfg"], case["pack"], case["hist1"],
                            case["bounds"])
    m, r = cfg.quorum, ROUND
    t, planes, n_w = pack.shape
    lanes = trials * n_w * 32
    eps = B2_EPS if coin_mode == "weak_common" else 0.0
    wids = obs_ids(n)
    vote = dict(m=m, n_faulty=cfg.n_faulty, rule="textbook",
                fault_model=fault_model, freeze=True)
    modes = dict(n_equiv=case["n_equiv"], coin_mode=coin_mode, eps=eps,
                 shared=case["shared"], **bnd)
    obs = dict(witness_ids=wids, n_local=n)

    def acc():
        """Both stages' counter accumulator, zeroed."""
        return torch.zeros((2, 1, pr.TELEM_WIDTH), dtype=torch.int32,
                           device=device)

    tel_k, tel_p = acc(), acc()
    out_k = pr.fused_round(SEED, r, hist, pack, **vote, **modes,
                           record=True, **obs, telemetry=tel_k)
    out_p = pr.fused_round_plain(SEED, r, hist, pack, **vote, **modes,
                                 record=True, **obs, telemetry=tel_p)
    out_u = pr.fused_round(SEED, r, hist, pack, **vote, **modes)
    pa = pr.proposal_hist(SEED, r, rng.PHASE_PROPOSAL, hist, pack, m,
                          fault_model, True, n_equiv=case["n_equiv"],
                          witness_ids=wids, n_local=n, **bnd)
    new_2, pb = pr.vote_commit(SEED, r, rng.PHASE_VOTE, pa[:, :3], pack,
                               pa[:, 3] >= m, **vote, **modes, record=True,
                               witness_ids=wids, n_local=n)
    torch.cuda.synchronize()
    tag = f"{coin_mode}/{fault_model}/{rejoin} T={trials} N={n}"
    res = compare(f"fused_round armed {tag}", lanes,
                  list(zip(out_k, out_p)) + [(tel_k, tel_p)]
                  + [(out_k[0], out_u[0]),
                     (out_k[1][:, :pr.PROP_COLS], out_u[1]),
                     (out_k[2][:, :pr.VOTE_COLS], out_u[2])])
    same = all(torch.equal(a, b)
               for a, b in zip(out_k[:3], (new_2, pa, pb)))
    print(f"[dispatch] obs fused_round armed vs the armed proposal_hist + "
          f"sum + vote_commit at {tag}: "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"armed fused and two-kernel rounds differ at {tag}")
    fault = pr.FAULT_ROUNDS.get(fault_model, 0)
    equiv = case["n_equiv"] is not None
    out = dict(res=res, lanes=lanes, grid=pr.fused_grid(
        lib, n_w, trials, device, coin_mode, equiv, fault, True),
        grid_unarmed=pr.fused_grid(lib, n_w, trials, device, coin_mode,
                                   equiv, fault))
    if timed:
        tel = acc()

        def armed():
            return pr.fused_round(SEED, r, hist, pack, **vote, **modes,
                                  record=True, **obs, telemetry=tel)

        def unarmed():
            return pr.fused_round(SEED, r, hist, pack, **vote, **modes)

        out["ms"] = repeats(armed)
        out["ms_queued"] = repeats(armed, queued=True)
        out["ms_unarmed"] = repeats(unarmed)
        out["ms_unarmed_queued"] = repeats(unarmed, queued=True)
        out["plain_ms"] = cuda_ms(lambda: pr.fused_round_plain(
            SEED, r, hist, pack, **vote, **modes, record=True, **obs,
            telemetry=tel), 3)
        op_bytes = sum(a.numel() * 4 for a in (bnd["crash_round"],
                                               bnd["recover_round"])
                       if a is not None)
        k = len(wids)
        out["bytes"] = (2 * pack.numel() * 4 + op_bytes + trials * 3 * 4
                        + trials * (pr.PROP_COLS + pr.VOTE_OBS_COLS) * 4
                        + trials * k * 8 * 4 + 2 * pr.TELEM_WIDTH * 4)
        if fault:
            nd = b2_needs(pack, out_p[0], "sampled", m,
                          (hist, out_p[1][:, :3]), out_p[1][:, 3] >= m)
        else:
            nd = mode_needs(pack, "sampled", equiv, m,
                            (hist, out_p[1][:, :3]), out_p[1][:, 3] >= m,
                            out_p[0], case["n_equiv"])
        per_lane = OPS_BOUNDS.get(fault_model, 0) + (
            OPS_AMNESIA if fault == 2 and rejoin == "amnesia" else 0)
        out["needs"] = nd
        out["ops"] = lanes * per_lane + sum(
            mode_ops(kk, lanes, t, n_w * t, planes - PACK_K, "sampled",
                     coin_mode, equiv, nd[f"{p}_draws"], nd[f"{p}_tails"],
                     nd[f"{p}_sizes"], nd["coins"])
            + obs_ops(kk, t, k, n_w * t, nd["vote_draws"])
            for kk, p in (("proposal_hist", "proposal"),
                          ("vote_commit", "vote")))
    return out


def obs_run(cfg, vals, fl):
    """run_consensus on fresh state -> (seconds, its return)."""
    import torch
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import init_state
    st = init_state(cfg, vals, fl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_consensus(cfg, st, fl)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def obs_check_run(tag, cfg, out, np_total):
    """The planes of an armed run against its final state: the last written
    recorder row equals the counts of the final state, every written row's
    classes sum to T x N, the last witness row's x / decided / killed are
    the final state's at the watched lanes, and the stage counters' real
    and pad lanes add up to T x N and T x (Np - N) a round and stage."""
    import torch
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.state import (WIT_DECIDED, WIT_KILLED, WIT_X,
                                       recorder_snapshot_row,
                                       witness_select)
    from benor_tpu_torch.utils.metrics import written_round_indices
    rounds, fin = out[0], out[1]
    rec = out[2]
    rows = written_round_indices(rec)
    last = rec[int(rows[-1])]
    want = recorder_snapshot_row(fin.x, fin.decided, fin.killed)
    classes = rec[torch.as_tensor(rows, device=rec.device), :5].sum(1)
    tn = cfg.trials * cfg.n_nodes
    ok = (int(rows[-1]) == rounds and torch.equal(last[:5], want[:5])
          and bool((classes == tn).all()))
    msg = f"last row {last.tolist()}, final-state counts {want[:5].tolist()}"
    if cfg.witness:
        wit = out[3]
        sel = [witness_select(cfg, f) for f in (fin.x, fin.decided,
                                                fin.killed)]
        got = [wit[rounds, :, :, c] for c in (WIT_X, WIT_DECIDED,
                                                WIT_KILLED)]
        ok = ok and all(torch.equal(a, b) for a, b in zip(got, sel))
        msg += f", witness rows {int((wit[:, 0, 0, -1] > 0).sum())}"
    if cfg.kernel_telemetry:
        tel = out[-1]
        act = tel[:, :, pr.TELEM_COLS["active_lanes"][0]].sum(1)
        pad = tel[:, :, pr.TELEM_COLS["pad_lanes"][0]].sum(1)
        ok = ok and (act.tolist() == [tn * rounds] * 2
                     and pad.tolist() == [cfg.trials * (np_total
                                                        - cfg.n_nodes)
                                          * rounds] * 2)
        msg += (f", telemetry active {act.tolist()} pad {pad.tolist()} "
                f"over {tel.shape[1]} tiles: "
                + ", ".join(f"{c} {tel[:, :, i].sum(1).tolist()}"
                            for i, c in enumerate(pr.TELEM_COLUMNS)))
    print(f"[obs] {tag}: rounds {rounds}, {len(rows)} written rows, {msg}: "
          f"{'consistent' if ok else 'INCONSISTENT'}")
    if not ok:
        raise SystemExit(f"[obs] {tag}: the planes disagree with the run")


def obs_phase(lib, dev, sms) -> dict:
    """The [obs] phase (see the module docstring): the armed twins of the
    round kernels.  Every armed instantiation against its plain version and
    the unarmed kernel; their times beside the unarmed ones; bench.py's
    flight-recorder regime at N = 1M x 32 three ways; packed against
    unfused; the fused kernel armed; card against CPU; the facade.  Any
    differing word, count or run raises SystemExit.  -> the kernels line's
    rows of the armed twins."""
    import torch
    from benor_tpu_torch import SimConfig, launch_network
    from benor_tpu_torch.ops import _build, sass
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs
    from benor_tpu_torch.utils.metrics import round_history_summary

    t_phase = time.perf_counter()
    cfg = main_cfg().replace(n_faulty=int(0.4 * N_MAIN))
    rows = {}

    def bound(nbytes, ops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    # 1. every armed instantiation of the pair on N = 1M x 32; the main
    # path's mode timed beside its unarmed kernel
    held, vote_call = set(), None
    for i, (cm, coin, fm, rj) in enumerate(OBS_PAIR):
        timed = i == 0
        res = obs_pair(lib, cfg, cm, coin, fm, rj, dev, SEED + 80 + i, timed)
        counts, coin_id, equiv, honest = pr._mode_ids(cm, coin, fm)
        pop = 2 if equiv else int(honest)
        fault = pr.FAULT_ROUNDS.get(fm, 0)
        held.add(sass.mode_label("proposal_hist_obs_kernel",
                                 (counts, pop, fault)))
        held.add(sass.mode_label("vote_commit_obs_kernel",
                                 (counts, coin_id, pop, fault)))
        print(f"[obs] pair {res['tag']}: witness entries written "
              f"{res['witnessed']}, margins of trials 0-3 {res['margin']}")
        if not res["witnessed"]:
            raise SystemExit(f"[obs] {res['tag']}: no witness field written")
        if not timed:
            continue
        vote_call = res["calls"]["vote_commit"]
        for k in ("proposal_hist", "vote_commit"):
            b_ms, by = bound(res["bytes"][k], res["ops"][k])
            med, med_u = median(res["ms"][k]), median(res["ms_unarmed"][k])
            print(f"[time] obs {k} armed ({res['tag']}, record + 16 watched "
                  f"nodes + telemetry): kernel {res['ms'][k]} ms (median "
                  f"{med:.4f}), unarmed {res['ms_unarmed'][k]} ms (median "
                  f"{med_u:.4f}), armed / unarmed {med / med_u:.3f}; plain "
                  f"armed {res['plain'][k]:.4f} ms; bound {b_ms:.4f} ms "
                  f"({by}; bytes {res['bytes'][k]} B, operations "
                  f"{res['ops'][k]} needed), share {b_ms / med:.3f}; "
                  f"library null")
            rows[f"{k}_obs"] = dict(
                name=f"{k}_obs", route="cuda",
                source="benor_tpu_torch/csrc/round_obs.cu",
                replaces=REPLACES[k], launches=0,
                max_abs_err=max(r_[1] for r_ in res["res"]), ms=med,
                plain_ms=res["plain"][k], bound_ms=b_ms, bound_by=by,
                library_ms=None, match="exact", differing=0,
                ms_repeats=res["ms"][k], unarmed_ms=med_u)
        del res
        torch.cuda.empty_cache()

    # 2. every armed instantiation of the fused kernel on its shape family,
    # timed at its cap N = 8192 x 32
    for coin, fm, rj in OBS_FUSED:
        fault = pr.FAULT_ROUNDS.get(fm, 0)
        for t_f, n_f in FUSED_FAMILY:
            timed = (coin, fm, t_f, n_f) == ("private", "crash",
                                             *FUSED_FAMILY[0])
            f = obs_fused(lib, t_f, n_f, coin, fm, rj, dev, timed)
            inst = sass.mode_label(
                "fused_cluster_obs_kernel" if f["grid"][0] > 1
                else "fused_round_obs_kernel",
                (pr.COIN_MODES.index(coin), int(fm == "equivocate"), fault))
            held.add(inst)
            if (t_f, n_f) == FUSED_FAMILY[0]:
                print(f"[grid] obs fused_round {coin}/{fm}/{rj} T={t_f} "
                      f"N={n_f}: armed (C, W) {f['grid']}, unarmed "
                      f"{f['grid_unarmed']}")
            if not timed:
                continue
            b_ms, by = bound(f["bytes"], f["ops"])
            med_q = median(f["ms_queued"])
            print(f"[time] obs fused_round armed ({coin}/{fm}, T={t_f} "
                  f"N={n_f}, grid {f['grid']}): wrapper {f['ms']} ms "
                  f"(median {median(f['ms']):.4f}), queued "
                  f"{f['ms_queued']} ms (median {med_q:.4f}); unarmed "
                  f"{f['ms_unarmed']} ms (median "
                  f"{median(f['ms_unarmed']):.4f}), queued "
                  f"{f['ms_unarmed_queued']} (median "
                  f"{median(f['ms_unarmed_queued']):.4f}); armed / unarmed "
                  f"queued {med_q / median(f['ms_unarmed_queued']):.3f}; "
                  f"plain armed {f['plain_ms']:.4f} ms; bound {b_ms:.5f} ms "
                  f"({by}; bytes {f['bytes']} B, operations {f['ops']} "
                  f"needed), share queued {b_ms / med_q:.3f}; library null")
            rows["fused_round_obs"] = dict(
                name="fused_round_obs", route="cuda",
                source="benor_tpu_torch/csrc/round_obs.cu",
                replaces=REPLACES["fused_round"], launches=0,
                max_abs_err=f["res"][1], ms=median(f["ms"]),
                plain_ms=f["plain_ms"], bound_ms=b_ms, bound_by=by,
                library_ms=None, match="exact", differing=0,
                ms_repeats=f["ms"], queued_ms=med_q,
                unarmed_ms=median(f["ms_unarmed"]),
                unarmed_queued_ms=median(f["ms_unarmed_queued"]))

    # 3. their registers, spills and SASS; every built one must have been
    # held
    res_all = {}
    for src in ("round_obs.cu", "round_obs_b2.cu"):
        res_all.update(sass.resource_report(_build.CSRC / src,
                                            _build.BUILD_DIR,
                                            sass.OBS_KERNELS))
    mhz = clock_during(vote_call)
    print(f"[clock] clocks.sm {mhz:.0f} MHz while the armed vote_commit ran")
    sass.print_resources("obs", {k: v for k, v in res_all.items()
                                 if not k.startswith("fused")},
                         TRIALS * N_MAIN, sms, mhz)
    sass.print_resources("obs", {k: v for k, v in res_all.items()
                                 if k.startswith("fused")},
                         TRIALS * N_FUSED, sms, mhz)
    spills = {k: (v.get("spill_stores"), v.get("spill_loads"))
              for k, v in res_all.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    untried = sorted(set(res_all) - held)
    if untried or not res_all:
        raise SystemExit(f"[obs] armed instantiations never held against "
                         f"their plain versions: {untried or 'none built'}")
    print(f"[ptxas] obs: {len(res_all)} armed instantiations; spilling: "
          f"{spills or 'none'}")

    # 4. bench.py's flight-recorder regime (bench.py:815-913) at
    # N = 1M x 32: record off, record on, record + witness + telemetry
    n = N_MAIN
    c_off = SimConfig(n_nodes=n, n_faulty=int(0.40 * n), **MAIN_RUN)
    c_on = c_off.replace(record=True)
    c_wit = c_off.replace(record=True, witness_trials=OBS_TRIALS,
                          witness_nodes=OBS_WITNESS, kernel_telemetry=True)
    fl = FaultSpec.none(TRIALS, n, device=dev)
    bal = balanced_inputs(TRIALS, n)
    np_total = n + (-n) % pr.TILE_N
    t_off, out0 = obs_run(c_off, bal, fl)
    pr.reset_launches()
    hk.reset_launches()
    t_on, out1 = obs_run(c_on, bal, fl)
    t_wit, out2 = obs_run(c_wit, bal, fl)
    armed = pr.obs_launch_counts()
    plain_launches = {k: fn.launches for k, fn in pr.KERNELS.items()}
    print(f"[obs] recorder regime launches: armed {armed}, unarmed "
          f"{plain_launches}")
    # record alone arms the vote pass (the proposal pass records nothing);
    # the witness and the counters arm both
    if (armed != {"proposal_hist_obs": out2[0],
                  "vote_commit_obs": out1[0] + out2[0],
                  "fused_round_obs": 0}
            or plain_launches != {"proposal_hist": out1[0],
                                  "vote_commit": 0, "fused_round": 0}):
        raise SystemExit("[obs] the armed runs did not take the armed "
                         "kernels once a round")
    for k in ("proposal_hist_obs", "vote_commit_obs"):
        rows[k]["launches"] = armed[k]
    same = (out0[0] == out1[0] == out2[0]
            and trials_differing(out0[1], out1[1]) == 0
            and trials_differing(out0[1], out2[1]) == 0
            and bool((out0[1].killed == out2[1].killed).all()))
    same_rec = torch.equal(out1[2], out2[2])
    print(f"[obs] balanced_f0.40 N={n} T={TRIALS}: rounds {out0[0]}, record "
          f"off == on == witness run {same}, record-only recorder == "
          f"witness run's {same_rec}")
    if not (same and same_rec):
        raise SystemExit("[obs] recorded and unrecorded runs differ")
    obs_check_run("balanced_f0.40 armed", c_wit, out2, np_total)
    times = {}
    for name, c in (("off", c_off), ("on", c_on)):
        ts = []
        for _ in range(3):
            ts.append(obs_run(c, bal, fl)[0])
        times[name] = ts
    summary = round_history_summary(out1[2])
    print(f"[obs] round_history_summary {json.dumps(summary)}")
    print(f"[obs] run_consensus seconds (3 runs each): unrecorded "
          f"{times['off']}, recorded {times['on']}; record_overhead_x "
          f"{median(times['on']) / median(times['off']):.3f} (first runs: "
          f"off {t_off:.4f}, on {t_on:.4f}, record + witness + telemetry "
          f"{t_wit:.4f})")

    # 5. packed against unfused, where both share every bit (the CF regime,
    # the private coin): the recorder and the witness
    c_unf = c_wit.replace(use_pallas_round=False, kernel_telemetry=False)
    _, out_u = obs_run(c_unf, bal, fl)
    same = (out_u[0] == out2[0] and trials_differing(out_u[1], out2[1]) == 0
            and torch.equal(out_u[2], out2[2])
            and torch.equal(out_u[3], out2[3]))
    print(f"[obs] balanced_f0.40 unfused vs packed: rounds {out_u[0]} vs "
          f"{out2[0]}, recorder and witness equal {same}")
    if not same:
        raise SystemExit("[obs] unfused and packed planes differ")
    del out0, out1, out2, out_u
    torch.cuda.empty_cache()

    # 6. the fused kernel armed: N = 8192 x 32 on balanced inputs, and the
    # 'at:1:4:amnesia' run; one armed fused launch a round
    c8 = SimConfig(n_nodes=N_FUSED, n_faulty=int(0.4 * N_FUSED),
                   **MAIN_RUN)
    (_, c_am, vals_am, fl_am), = [
        x for x in b2_regimes(N_FUSED, TRIALS, device=dev)
        if x[0] == "recover_at1_4_amnesia_f0.45"]
    pr.reset_launches()
    fused_launches = 0
    for tag, c, vals, fl8 in (
            ("fused balanced_f0.40", c8, balanced_inputs(TRIALS, N_FUSED),
             FaultSpec.none(TRIALS, N_FUSED, device=dev)),
            ("fused recover_at1_4_amnesia", c_am, vals_am, fl_am)):
        armed_c = c.replace(record=True, witness_trials=OBS_TRIALS,
                            witness_nodes=OBS_WITNESS, kernel_telemetry=True)
        before = pr.obs_launch_counts()
        _, off = obs_run(c, vals, fl8)
        _, on = obs_run(armed_c, vals, fl8)
        grown = {k: v - before[k] for k, v in pr.obs_launch_counts().items()}
        fused_launches += grown["fused_round_obs"]
        same = (off[0] == on[0] and trials_differing(off[1], on[1]) == 0)
        print(f"[obs] {tag} N={N_FUSED} T={TRIALS}: rounds {on[0]}, record "
              f"off == armed {same}, armed launches {grown}")
        if not same or grown != {"proposal_hist_obs": 0,
                                 "vote_commit_obs": 0,
                                 "fused_round_obs": on[0]}:
            raise SystemExit(f"[obs] {tag}: not one armed fused launch a "
                             "round, or the armed run differs")
        obs_check_run(tag, armed_c, on, N_FUSED)
    rows["fused_round_obs"]["launches"] = fused_launches

    # 7. the card against the CPU at small sizes: recorder, witness and
    # stage counters
    for n_s, t_s in OBS_SMALL:
        pick = {d: [x for x in item8_regimes(n_s, t_s, device=d)
                    + b2_regimes(n_s, t_s, device=d)
                    if x[0] in OBS_SMALL_RUNS] for d in ("cuda", "cpu")}
        for (name, c, vals, fg), (_, _, _, fc) in zip(pick["cuda"],
                                                       pick["cpu"]):
            c = c.replace(record=True,
                          witness_trials=tuple(range(min(4, t_s))),
                          witness_nodes=OBS_WITNESS, kernel_telemetry=True)
            tg, og = obs_run(c, vals, fg)
            t0 = time.perf_counter()
            oc = run_consensus(c, init_state(c, vals, fc), fc)
            tc = time.perf_counter() - t0
            same = (og[0] == oc[0] and trials_differing(og[1], oc[1]) == 0
                    and all(torch.equal(a.cpu(), b)
                            for a, b in zip(og[2:], oc[2:])))
            print(f"[obs] card vs cpu {name} N={n_s} T={t_s}: rounds "
                  f"{og[0]} / {oc[0]}, state, recorder, witness and "
                  f"telemetry equal {same} (cpu {tc:.2f} s, card {tg:.3f} s)")
            if not same:
                raise SystemExit(f"[obs] {name} N={n_s}: card and CPU "
                                 "differ")

    # 8. the facade: the round history and the witness through
    # launch_network with poll_rounds, card == cpu
    name, faulty, values, kw = next(sc for sc in SCENARIOS
                                    if "livelock" in sc[0])
    got = {}
    for d in ("cuda", "cpu"):
        net = launch_network(len(faulty), sum(faulty), values, faulty,
                             device=d, poll_rounds=2, record=True,
                             witness_trials=(0,), witness_nodes=4, **kw)
        seen = []
        net.start(on_slice=lambda: seen.append(
            len(net.get_round_history())))
        got[d] = (net.get_round_history(since_round=3), net.get_witness(),
                  seen)
    same = got["cuda"] == got["cpu"]
    print(f"[api] {name} poll_rounds=2 record + witness: history rows seen "
          f"after each slice {got['cuda'][2]}, rows past round 3 "
          f"{len(got['cuda'][0])}, witness rows {len(got['cuda'][1])}, card "
          f"== cpu {same}")
    if not same or not got["cuda"][1]:
        raise SystemExit("[api] the facade's round history or witness "
                         "differs between card and CPU")
    print(f"[obs] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


# --- the [samplers] phase: the histogram path's plain samplers and the
# omission and partition planes, plain torch with no kernel -------------------

SAMPLERS_F = 0.25         # bench.py:331-336's biased regimes' fault fraction
SAMPLERS_SMALL = ((8192, 8), (16_384, 4))
SAMPLERS_EXACT = (4096, 8)  # quorums within EXACT_TABLE_MAX: the exact tables
SAMPLERS_DENSE = (1024, 4)  # the dense path's partition epoch on the mask
SAMPLERS_HEAL = 4         # bench.py:1677's 'halves:4'
SAMPLERS_DROP = 0.05      # bench.py:1687-1692's omission point


def sampler_regimes(n, trials, max_rounds=MAX_ROUNDS, device="cuda"):
    """(name, config, inputs, faults) of the six regimes at N = n: the
    biased scheduler at strengths 0.5 and 1.5, built as bench.py:305-336
    builds them (f = 0.25, use_pallas_* on: the unfused loop takes them, no
    fused sampler serves the biased scheduler); the uniform scheduler with
    use_pallas_hist=False (the JAX package's default, the plain CF draws);
    delivery='all' with drop_prob 0.05, F = N/4 and no crashes
    (bench.py:1687-1692); 'halves:4' with F = N/8, the first F lanes
    crashed (bench.py:1677, audit_point's default faults); 'halves:4' with
    drop_prob 0.05, F = N/8 and no crashes (crashes would pin the live
    population to the quorum and thinning would stall every lane for
    good).  Balanced inputs."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs
    q = dict(trials=trials, max_rounds=max_rounds, delivery="quorum",
             path="histogram", fault_model="crash", seed=SEED,
             use_pallas_hist=True, use_pallas_round=True)
    a = dict(trials=trials, max_rounds=max_rounds, delivery="all",
             path="histogram", fault_model="crash", seed=SEED)
    bal = balanced_inputs(trials, n)
    none = FaultSpec.none(trials, n, device=device)
    f = int(SAMPLERS_F * n)
    out = [(f"biased_s{s}", SimConfig(n_nodes=n, n_faulty=f,
                                      scheduler="biased",
                                      adversary_strength=s, **q), bal, none)
           for s in (0.5, 1.5)]
    out.append(("uniform_xla_f0.25",
                SimConfig(n_nodes=n, n_faulty=f, **{
                    **q, "use_pallas_hist": False,
                    "use_pallas_round": False}), bal, none))
    out.append((f"omission_p{SAMPLERS_DROP}",
                SimConfig(n_nodes=n, n_faulty=n // 4,
                          drop_prob=SAMPLERS_DROP, **a), bal, none))
    c = SimConfig(n_nodes=n, n_faulty=n // 8,
                  partition=f"halves:{SAMPLERS_HEAL}", **a)
    out.append((f"halves{SAMPLERS_HEAL}", c, bal,
                FaultSpec.first_f(c, device=device)))
    out.append((f"halves{SAMPLERS_HEAL}_p{SAMPLERS_DROP}",
                SimConfig(n_nodes=n, n_faulty=n // 8,
                          partition=f"halves:{SAMPLERS_HEAL}",
                          drop_prob=SAMPLERS_DROP, **a), bal, none))
    return out


def sampler_small_extra(n, trials, device="cuda"):
    """The branches the six do not reach, for the card-against-CPU runs:
    equivocation on the plain sampler (CF above the bound, the exact
    h_b table within it), the biased scheduler at strength 1.0, and at the
    exact-table size the uniform and strict biased samplers' tables."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs
    q = dict(trials=trials, max_rounds=MAX_ROUNDS, delivery="quorum",
             path="histogram", seed=SEED, use_pallas_hist=False)
    bal = balanced_inputs(trials, n)
    none = FaultSpec.none(trials, n, device=device)
    c = SimConfig(n_nodes=n, n_faulty=n // 5, fault_model="equivocate", **q)
    out = [("equiv_xla_f0.20", c, bal, FaultSpec.first_f(c, device=device)),
           ("biased_s1.0", SimConfig(n_nodes=n, n_faulty=n // 4,
                                     scheduler="biased",
                                     adversary_strength=1.0, **q), bal,
            none)]
    if (n, trials) == SAMPLERS_EXACT:
        out += [("uniform_exact", SimConfig(n_nodes=n, n_faulty=n // 4, **q),
                 bal, none),
                ("biased_s1.5_exact", SimConfig(
                    n_nodes=n, n_faulty=n // 4, scheduler="biased",
                    adversary_strength=1.5, **q), bal, none)]
    return out


def first_round_differing(a, b):
    """The first round whose recorder rows differ, or None."""
    rows = (a.cpu() != b.cpu()).any(dim=1).nonzero()
    return int(rows[0]) if rows.numel() else None


def sampler_split(dev) -> None:
    """The samplers' draws on the card against the same calls on the CPU,
    on one round's uniforms at N = 1M x 4 (bench.py's f = 0.25 histograms):
    the CDF tables and their exact draws, the partition's group counts
    (integers: any difference fails), and the normal-quantile draws (the
    two-class CF sampler, the mixed-population sampler, the biased
    scheduler's strict and fractional forms, the thinning draw; their
    differing counts printed)."""
    import torch
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.faults import parse_partition
    from benor_tpu_torch.ops import rng, sampling, tally
    t, n = 4, N_MAIN
    tid, nid = rng.ids(t, device=dev), rng.ids(n, device=dev)
    u = [rng.grid_uniforms(SEED, 1, salt, tid, nid) for salt in (0, 16, 32, 48)]
    m = n - int(SAMPLERS_F * n)
    hist = torch.tensor([[375_000, 375_000, 0], [400_000, 300_000, 50_000],
                         [0, 750_000, 0], [250_000, 250_000, 250_000]],
                        dtype=torch.int32, device=dev)
    n_equiv = torch.tensor([0, 1000, 250_000, 37], dtype=torch.int32,
                           device=dev)
    cpu = torch.device("cpu")

    def both(fn, *args):
        moved = [a.to(cpu) if torch.is_tensor(a) else a for a in args]
        return fn(*args).cpu(), fn(*moved)

    # the tables (host-built) and their exact draws, at the largest quorum
    # the tables serve
    m_t = sampling.EXACT_TABLE_MAX
    total = torch.tensor([4096, 5000, 8192, 65_536], dtype=torch.int32,
                         device=dev)
    good = torch.tensor([2048, 1000, 8000, 30_000], dtype=torch.int32,
                        device=dev)
    tab_g, tab_c = both(sampling.hypergeom_cdf_table, total, good, m_t)
    ex_g, ex_c = both(sampling.hypergeom_exact_shared, u[0], total, good,
                      m_t)
    node_ids = rng.ids(n, device=dev)
    # favored populations above and below the tables' m, both parities
    hist_t = torch.tensor([[5000, 3000, 500], [3000, 5000, 0],
                           [4096, 4096, 0], [2000, 2000, 3000]],
                          dtype=torch.int32, device=dev)
    cfg = SimConfig(n_nodes=n, n_faulty=n // 8, trials=t, delivery="all",
                    partition="groups:3:4")
    part = parse_partition(cfg.partition)
    sent = (u[1] * 3).to(torch.int8)
    honest = u[2] < 0.9
    integer = {
        "cdf tables": (tab_g, tab_c),
        "exact table draws": (ex_g, ex_c),
        "partition_counts r=1": both(tally.partition_counts, cfg, part,
                                     sent, honest, node_ids, 1),
        "partition_counts r=4": both(tally.partition_counts, cfg, part,
                                     sent, honest, node_ids, 4),
    }
    quantile = {
        "multivariate CF": both(sampling.multivariate_hypergeom_counts,
                                u[0], u[1], hist, m),
        "equivocate CF": both(sampling.equivocate_hypergeom_counts,
                              u[2], u[0], u[1], u[3], hist, n_equiv, m),
        "biased strict CF": both(tally.biased_priority_counts, u[0], hist,
                                 m, node_ids),
        "biased strict, exact tables": both(tally.biased_priority_counts,
                                            u[0], hist_t, m_t, node_ids),
        "biased fractional s=0.5": both(tally.biased_fractional_counts, 0.5,
                                        u[0], u[1], hist, m, node_ids),
        "binomial_keep p=0.05": both(
            sampling.binomial_keep, u[3], hist.sum(-1, keepdim=True),
            torch.tensor(0.95, dtype=torch.float32, device=dev)),
    }
    bad = [k for k, (g, c) in integer.items() if not torch.equal(g, c)]
    print(f"[samplers] split card vs cpu over {t} x {n} lanes: "
          + ", ".join(f"{k} equal {k not in bad}" for k in integer)
          + "; normal-quantile draws differing: "
          + ", ".join(f"{k} {int((g != c).sum())} of {g.numel()}"
                      for k, (g, c) in quantile.items()))
    if bad:
        raise SystemExit(f"[samplers] card and CPU differ on {bad}")


def samplers_phase(dev) -> None:
    """Phase 12: the histogram path's remaining count sources and the
    omission and partition planes at N = 1M x 32, card against CPU, the
    draws card against CPU, one profiled run; no kernel may launch."""
    import torch
    from benor_tpu_torch import SimConfig, simulate
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import tally
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    for ops in (dk, hk, pr):
        ops.reset_launches()
    obs_before = pr.obs_launch_counts()

    # (a) the six regimes at N = 1M x 32
    runs = sampler_regimes(N_MAIN, TRIALS, device=dev)
    t_runs = {}
    for name, c, vals, fl in runs:
        assert not tally.pallas_round_active(c)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        biased = c.scheduler == "biased"
        split = check_final(c, rounds, fin, agreement=not biased)
        live = ~fin.killed
        dec = int(fin.decided.sum()) / max(int(live.sum()), 1)
        peak = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        st = init_state(c, vals, fl)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2, fin2 = run_consensus(c, st, fl)
        torch.cuda.synchronize()
        t_run = t_runs[name] = time.perf_counter() - t0
        if r2 != rounds or trials_differing(fin, fin2):
            raise SystemExit(f"[samplers] {name}: a rerun differs")
        print(f"[samplers] {name}: N={c.n_nodes} T={c.trials} "
              f"F={c.n_faulty} rounds {rounds} decided {dec:.6f} disagree "
              f"{split / c.trials:.6f} ({split} trials decided both) "
              f"simulate {sec:.4f} s trials/s {c.trials / sec:.3f}; "
              f"init_state {t_init:.4f} s, run_consensus {t_run:.4f} s "
              f"({c.trials / t_run:.3f} trials/s); peak_mem {peak:.1f} MiB; "
              f"{card}")
        if c.partition is not None:
            # the verdict of test_partition_stalls_until_heal: every live
            # lane decides, none before the heal (k = r + 1 > heal)
            stalled = bool(fin.decided[live].all()) and bool(
                (fin.k[fin.decided] > SAMPLERS_HEAL).all()) and \
                rounds >= SAMPLERS_HEAL
            k_min = int(fin.k[fin.decided].min())
            print(f"[samplers] {name}: stalled until the heal at round "
                  f"{SAMPLERS_HEAL}, then decided: {stalled} (smallest "
                  f"decided k {k_min})")
            if not stalled:
                raise SystemExit(f"[samplers] {name}: did not stall until "
                                 "the heal and then decide")
        del fin, fin2, st
    name, c, vals, fl = runs[1]                          # biased_s1.5
    st = init_state(c, vals, fl)
    breakdown("samplers", name, lambda: run_consensus(c, st, fl),
              t_runs[name], (), torch_ops=True)
    del st, runs
    torch.cuda.empty_cache()

    # (b) the card against the CPU: the draws, then whole runs with the
    # recorder armed (the first round whose row differs)
    sampler_split(dev)
    n_d, t_d = SAMPLERS_DENSE
    dense = ("halves4_p0.05_dense", SimConfig(
        n_nodes=n_d, n_faulty=n_d // 8, trials=t_d, max_rounds=MAX_ROUNDS,
        delivery="all", path="dense", seed=SEED,
        partition=f"halves:{SAMPLERS_HEAL}", drop_prob=SAMPLERS_DROP),
        balanced_inputs(t_d, n_d))
    shapes = SAMPLERS_SMALL + (SAMPLERS_EXACT, SAMPLERS_DENSE)
    for n_s, t_s in shapes:
        pick = {}
        for d in ("cuda", "cpu"):
            if (n_s, t_s) == SAMPLERS_DENSE:
                name, c, vals = dense
                pick[d] = [(name, c, vals,
                            FaultSpec.none(t_s, n_s, device=d))]
            elif (n_s, t_s) == SAMPLERS_EXACT:
                pick[d] = sampler_small_extra(n_s, t_s, device=d)
            else:
                pick[d] = (sampler_regimes(n_s, t_s, device=d)
                           + sampler_small_extra(n_s, t_s, device=d))
        for (name, c, vals, fg), (_, _, _, fc) in zip(pick["cuda"],
                                                       pick["cpu"]):
            c = c.replace(record=True)
            outs = {}
            for d, fl in (("cuda", fg), ("cpu", fc)):
                t0 = time.perf_counter()
                outs[d] = run_consensus(c, init_state(c, vals, fl), fl)
                outs[d] = (*outs[d], time.perf_counter() - t0)
            (rg, fing, recg, tg), (rc, finc, recc, tcpu) = (outs["cuda"],
                                                           outs["cpu"])
            diff = trials_differing(fing, finc)
            first = first_round_differing(recg, recc)
            print(f"[samplers] card vs cpu {name} N={n_s} T={t_s} "
                  f"F={c.n_faulty}: rounds cuda {rg} cpu {rc}, trials "
                  f"differing {diff} of {t_s}, first round differing "
                  f"{first} (cpu {tcpu:.2f} s, card {tg:.3f} s)")
            if c.partition is not None and not c.drop_prob and (
                    diff or rg != rc or first is not None):
                # integer group histograms and threefry coins only
                raise SystemExit(f"[samplers] {name}: card and CPU differ")

    # (d) no kernel ran in this phase
    launched = {k: fn.launches for table in tables
                for k, fn in table.items()}
    obs = {k: v - obs_before[k] for k, v in pr.obs_launch_counts().items()}
    print(f"[samplers] kernel launches in the phase: {launched}, armed "
          f"{obs}")
    if any(launched.values()) or any(obs.values()):
        raise SystemExit("[samplers] a kernel launched on the plain "
                         "samplers' path")
    print(f"[samplers] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [topo] phase: topologies, committees and the debug callback ------

TOPO_MAX_ROUNDS = 32      # results.topo_curves' round cap
# the trials of the ladders and the mixes at N = 1M: half the main path's
# 32, the script's depth cut that keeps it near 800 s (the equivocate mix
# alone took ~100 s at 32 trials, two runs)
TOPO_TRIALS = TRIALS // 2
# the equivocate mix's trials at N = 1M: half again (~50 s at 16 trials),
# the next depth cut, which the [serve] and [heartbeat] phases pay for
TOPO_EQUIV_TRIALS = TOPO_TRIALS // 2
TOPO_FAULTY = 0.05        # the fault mixes' faulty share (the first lanes)
TOPO_MIX_SPEC = "ring:8"
TOPO_SMALL = (8192, 8)    # card against CPU (torus2d:64x128 for the torus)
TOPO_DEBUG = (8192, 32)   # the debug run's north-star shape
TOPO_EQUIV_CPU_ROUNDS = 6  # the equivocate mix's rounds held card vs CPU


def topo_degree_specs(n):
    """The degree ladder of the JAX package's science harness
    (benor_tpu/topo/curves.py default_degree_specs): rings of degree 2, 4
    and 8, the square torus where N is a square (64 x 128 at N = 8192),
    random_regular:6:1.  F = d on each (curves.unanimity_fault)."""
    import math
    side = math.isqrt(n)
    specs = ["ring:2", "ring:4", "ring:8"]
    if side * side == n and side >= 3:
        specs.append(f"torus2d:{side}x{side}")
    elif n == 8192:
        specs.append("torus2d:64x128")
    specs.append("random_regular:6:1")
    return specs


def topo_runs(n, trials, device="cuda", equiv_trials=None):
    """(name, config, inputs, faults) of the [topo] runs at N = n: the
    degree ladder (F = d, zero crashes, per-trial random inputs); the
    committee ladder of results.topo_curves (count = cap = 4, sizes N/16,
    N/8 and N/4, F = 1, zero crashes); the fault mixes on ring:8 with
    F = 8 (byzantine and equivocate with the first 5 % of the lanes faulty,
    'halves:4' with no crashes, crash_at_round with the first 5 % dying
    at round 2) and the committee mix (size N/8, byzantine 5 %).  The
    equivocate mix runs the first ``equiv_trials`` trials when given."""
    import torch
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import random_inputs
    base = dict(trials=trials, max_rounds=TOPO_MAX_ROUNDS, seed=SEED)
    vals = random_inputs(SEED, trials, n)
    none = FaultSpec.none(trials, n, device=device)
    first = torch.zeros((trials, n), dtype=torch.bool, device=device)
    first[:, :int(TOPO_FAULTY * n)] = True

    def mix(crash_round=0):
        return FaultSpec(first, torch.where(
            first, crash_round, 0).to(torch.int32))

    out = []
    for spec in topo_degree_specs(n):
        d = int(spec.split(":")[1]) if not spec.startswith("torus") else 4
        out.append((f"degree_{spec}", SimConfig(
            n_nodes=n, n_faulty=d, topology=spec, **base), vals, none))
    for size in (n // 16, n // 8, n // 4):
        out.append((f"committee_c{size}", SimConfig(
            n_nodes=n, n_faulty=1, committee_cap=4, committee_count=4,
            committee_size=size, **base), vals, none))
    ring = dict(n_nodes=n, n_faulty=8, topology=TOPO_MIX_SPEC, **base)
    et = trials if equiv_trials is None else equiv_trials
    fe = mix()
    out += [
        ("ring8_byzantine", SimConfig(fault_model="byzantine", **ring),
         vals, mix()),
        ("ring8_equivocate", SimConfig(fault_model="equivocate",
                                       **{**ring, "trials": et}),
         vals[:et], FaultSpec(fe.faulty[:et], fe.crash_round[:et])),
        ("ring8_halves4", SimConfig(partition="halves:4", **ring), vals,
         none),
        ("ring8_crash_at_2", SimConfig(fault_model="crash_at_round", **ring),
         vals, mix(2)),
        ("committee_byzantine", SimConfig(
            n_nodes=n, n_faulty=1, committee_cap=4, committee_count=4,
            committee_size=n // 8, fault_model="byzantine", **base), vals,
         mix()),
    ]
    return out


def topo_phase(dev) -> None:
    """Phase 13: topologies, committees and the debug callback.  The
    degree ladder, the committee ladder and the fault mixes at N = 1M x 16
    (rounds, decided and disagree fractions, the smallest decided k,
    trials/s over simulate and over run_consensus, peak memory), two
    profiled runs, card against CPU at 8192 x 8 (every trial and every
    recorder row equal), 'complete' against no topology, zero kernel
    launches; then debug=True on a packed-eligible config at 8192 x 32:
    the demotion warning, one event a round, the final state and the
    round kernel launches equal to the packed run's."""
    import warnings
    import torch
    from benor_tpu_torch import SimConfig, simulate
    from benor_tpu_torch import sim as tsim
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import tally
    from benor_tpu_torch.sim import run_consensus
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import balanced_inputs, random_inputs
    from benor_tpu_torch.utils import tracing
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    for ops in (dk, hk, pr):
        ops.reset_launches()
    obs_before = pr.obs_launch_counts()

    # (a) the ladders and the mixes at N = 1M x TOPO_TRIALS
    runs = topo_runs(N_MAIN, TOPO_TRIALS, device=dev,
                     equiv_trials=TOPO_EQUIV_TRIALS)
    t_runs = {}
    for name, c, vals, fl in runs:
        assert not tally.pallas_round_active(c)
        assert tsim.delivery_plane(c) != "complete"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rounds, fin, _ = simulate(c, vals, faults=fl, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        # agreement is counted, not asserted: two regions of a sparse
        # graph, or two committees, may each decide their own value
        split = check_final(c, rounds, fin, agreement=False)
        live = ~fin.killed
        dec = int(fin.decided.sum()) / max(int(live.sum()), 1)
        k_min = (int(fin.k[fin.decided].min()) if bool(fin.decided.any())
                 else None)
        t0 = time.perf_counter()
        st = init_state(c, vals, fl)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2, fin2 = run_consensus(c, st, fl)
        torch.cuda.synchronize()
        t_run = t_runs[name] = time.perf_counter() - t0
        if r2 != rounds or trials_differing(fin, fin2):
            raise SystemExit(f"[topo] {name}: a rerun differs")
        print(f"[topo] {name}: N={c.n_nodes} T={c.trials} F={c.n_faulty} "
              f"plane {tsim.delivery_plane(c)} rounds {rounds} decided "
              f"{dec:.6f} disagree {split / c.trials:.6f} ({split} trials "
              f"decided both) smallest decided k {k_min}; simulate "
              f"{sec:.4f} s trials/s {c.trials / sec:.3f}; init_state "
              f"{t_init:.4f} s, run_consensus {t_run:.4f} s "
              f"({c.trials / t_run:.3f} trials/s); peak_mem {peak:.1f} MiB; "
              f"{card}")
        del fin, fin2, st
    for name in ("degree_ring:8", f"committee_c{N_MAIN // 8}"):
        _, c, vals, fl = next(r for r in runs if r[0] == name)
        st = init_state(c, vals, fl)
        breakdown("topo", name, lambda: run_consensus(c, st, fl),
                  t_runs[name], (), torch_ops=True)
    del st, runs
    torch.cuda.empty_cache()

    # (b) the card against the CPU at 8192 x 8, the recorder armed: integer
    # gathers and threefry streams only, so any difference fails.  The
    # equivocate mix draws 8192 x 8 x 9 edge bits a phase in int64 threefry,
    # seconds a round on the host: its first TOPO_EQUIV_CPU_ROUNDS rounds
    n_s, t_s = TOPO_SMALL
    for (name, c, vals, fg), (_, _, _, fc) in zip(
            topo_runs(n_s, t_s, device="cuda"),
            topo_runs(n_s, t_s, device="cpu")):
        c = c.replace(record=True)
        if c.fault_model == "equivocate":
            c = c.replace(max_rounds=TOPO_EQUIV_CPU_ROUNDS)
        outs = {}
        for d, fl in (("cuda", fg), ("cpu", fc)):
            t0 = time.perf_counter()
            outs[d] = (*run_consensus(c, init_state(c, vals, fl), fl),
                       time.perf_counter() - t0)
        (rg, fing, recg, tg), (rc, finc, recc, tcpu) = (outs["cuda"],
                                                       outs["cpu"])
        diff = trials_differing(fing, finc)
        first = first_round_differing(recg, recc)
        print(f"[topo] card vs cpu {name} N={n_s} T={t_s} F={c.n_faulty}: "
              f"rounds cuda {rg} cpu {rc}, trials differing {diff} of "
              f"{t_s}, first recorder row differing {first} (cpu "
              f"{tcpu:.2f} s, card {tg:.3f} s)")
        if rg != rc or diff or first is not None:
            raise SystemExit(f"[topo] {name}: card and CPU differ")

    # (c) 'complete' is the run without a topology
    fin = {}
    for topo in ("complete", None):
        c = SimConfig(n_nodes=n_s, n_faulty=n_s // 5, trials=t_s,
                      max_rounds=TOPO_MAX_ROUNDS, seed=SEED, topology=topo)
        fin[topo] = simulate(c, random_inputs(SEED, t_s, n_s),
                             [i < c.n_faulty for i in range(n_s)],
                             device="cuda")
    same = (fin["complete"][0] == fin[None][0]
            and not trials_differing(fin["complete"][1], fin[None][1]))
    print(f"[topo] 'complete' at N={n_s} T={t_s}: rounds "
          f"{fin['complete'][0]}, equal to the run without a topology: "
          f"{same}")
    if not same:
        raise SystemExit("[topo] 'complete' differs from no topology")

    # (d) no kernel ran on the structured planes
    launched = {k: fn.launches for table in tables
                for k, fn in table.items()}
    obs = {k: v - obs_before[k] for k, v in pr.obs_launch_counts().items()}
    print(f"[topo] kernel launches on the structured planes: {launched}, "
          f"armed {obs}")
    if any(launched.values()) or any(obs.values()):
        raise SystemExit("[topo] a kernel launched on a structured plane")

    # (e) debug=True on a packed-eligible config: the packed loop,
    # announced, one event a round, the packed run's final state and its
    # round kernel launches
    n_d, t_d = TOPO_DEBUG
    c = SimConfig(n_nodes=n_d, n_faulty=int(0.40 * n_d),
                  **{**MAIN_RUN, "trials": t_d})
    vals = balanced_inputs(t_d, n_d)
    fl = FaultSpec.none(t_d, n_d, device=dev)
    pr.reset_launches()
    packed = simulate(c, vals, faults=fl, device="cuda")
    packed_launches = {k: fn.launches for k, fn in pr.KERNELS.items()}
    events = []

    def sink(*row):
        events.append(row)
    pr.reset_launches()
    tsim._debug_demotion_warned = False
    tracing.add_sink(sink)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            rounds, st, _ = simulate(c.replace(debug=True), vals, faults=fl,
                                     device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
    finally:
        tracing.remove_sink(sink)
    debug_launches = {k: fn.launches for k, fn in pr.KERNELS.items()}
    round_launches = sum(debug_launches.values())
    warned = [str(w.message) for w in caught
              if "debug=True" in str(w.message)]
    print(f"[topo] debug warning: {warned[0] if warned else None}")
    ok = (bool(warned) and len(events) == rounds == packed[0]
          and [e[0] for e in events] == list(range(2, rounds + 2))
          and events[-1][1] == int(st.decided.sum())
          and not trials_differing(st, packed[1])
          and debug_launches == packed_launches
          and round_launches > 0 and round_launches % len(events) == 0)
    print(f"[topo] debug N={n_d} T={t_d} F={c.n_faulty}: {len(events)} "
          f"events over {rounds} rounds, last {events[-1] if events else None}"
          f", final decided {int(st.decided.sum())}, equal to the packed "
          f"run: {not trials_differing(st, packed[1])}, round kernel "
          f"launches {debug_launches} (packed run {packed_launches}), "
          f"histogram kernel launches "
          f"{sum(fn.launches for fn in hk.KERNELS.values())}; simulate "
          f"{sec:.4f} s: {ok}")
    if not ok:
        raise SystemExit("[topo] the debug run failed its checks")
    print(f"[topo] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [sweep] phase: the sweep engine, its journal and checkpoints ------

SWEEP_FRACS = (0.12, 0.22, 0.32, 0.42, 0.44)  # bench.py:744-800's check
SWEEP_ROUNDS = 16         # ... and its round cap
SWEEP_JOURNAL_CUT = 3     # journal records kept before the torn line
SWEEP_CKPT_ROUND = 3      # the checkpoint's round (or the run's last)
SWEEP_SMALL = (8192, 8)   # card against CPU, and its curves' axes:
SWEEP_DEGREE_SPECS = ("ring:2", "ring:8", "torus2d:64x128")
SWEEP_COMMITTEE_SIZES = (512, 1024, 2048)   # N/16, N/8, N/4


def sweep_science(pt) -> tuple:
    """A SweepPoint's fields but its clocks."""
    return (pt.n_nodes, pt.n_faulty, pt.trials, pt.coin_mode, pt.scheduler,
            pt.rounds_executed, pt.decided_frac, pt.mean_k, pt.ones_frac,
            pt.disagree_frac, pt.k_hist.tolist())


def sweep_records(path) -> list:
    """(kind, point indices, fingerprint, payload digest, payloads) of the
    journal's bucket records."""
    from benor_tpu_torch.sweepscope.journal import BUCKET_KIND, read_journal
    return [(r["bucket_kind"], r["point_indices"], r["fingerprint"],
             r["payload_sha256"], r["points"])
            for r in read_journal(str(path)) if r["kind"] == BUCKET_KIND]


def sweep_phase(dev) -> None:
    """Phase 14: the sweep engine.  bench.py's north star (five balanced,
    zero-crash points at N = 1M x 32, the round kernels) through one
    run_points_batched call, each point equal to run_point's; bench.py's
    batched check (five f values in one dynamic bucket on the plain CF
    samplers, max_rounds 16) equal to the per-point loop; the two lists in
    one journaled call, the journal cut after its third record with a
    torn line, resumed serially and pipelined (restored buckets launch no
    round kernel; points and records equal); a checkpoint of the f = 0.45
    run resumed to the uninterrupted run; card against CPU at 8192 x 8 on
    a mixed list, coin_comparison_batched, degree_curve and
    committee_curve."""
    import tempfile
    from pathlib import Path
    import torch
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sim import (run_consensus, run_consensus_slice,
                                     start_state)
    from benor_tpu_torch.state import FaultSpec, init_state
    from benor_tpu_torch.sweep import (balanced_inputs,
                                       coin_comparison_batched,
                                       run_curve_batched, run_point,
                                       run_points_batched, summarize_final)
    from benor_tpu_torch.topo.curves import committee_curve, degree_curve
    from benor_tpu_torch.utils.checkpoint import resume_from, save_checkpoint
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    total = {}              # the phase's launches, summed over its parts

    def launches():
        return {k: fn.launches for t in tables for k, fn in t.items()
                if fn.launches}

    def reset():
        for k, v in launches().items():
            total[k] = total.get(k, 0) + v
        for ops in (dk, hk, pr):
            ops.reset_launches()

    reset()
    total.clear()
    bal = balanced_inputs(TRIALS, N_MAIN)

    def none(c=None):
        return FaultSpec.none(TRIALS, N_MAIN)

    # (a) the north star through the engine: five static buckets on the
    # round kernels, each point equal to run_point's
    ns_base = SimConfig(n_nodes=N_MAIN, n_faulty=0, **MAIN_RUN)
    ns = [ns_base.replace(n_faulty=int(f * N_MAIN)) for f in FRACS]
    reset()
    cb = run_points_batched(ns_base, ns, initial_values=bal, faults_for=none,
                            device=dev)
    ns_launch = launches()
    rates = [round(p.trials_per_sec, 3) for p in cb.points]
    print(f"[sweep] north star N={N_MAIN} T={TRIALS}: {cb.n_buckets} "
          f"buckets {cb.bucket_kinds}, rounds "
          f"{[p.rounds_executed for p in cb.points]}, trials/s {rates}, "
          f"wall_s {cb.wall_s:.4f}, run_s {cb.run_s:.4f}, compile_count "
          f"{cb.compile_count} ({cb.compile_s:.4f} s), kernel launches "
          f"{ns_launch}; {card}")
    ok = (cb.bucket_kinds == ["static"] * len(FRACS)
          and ns_launch.get("proposal_hist", 0) > 0
          and ns_launch.get("vote_commit", 0) > 0
          and set(ns_launch) == {"proposal_hist", "vote_commit"})
    for c, pt in zip(ns, cb.points):
        ref_pt = run_point(c, initial_values=bal, faults=none(), device=dev)
        same = sweep_science(ref_pt) == sweep_science(pt)
        ok = ok and same
        print(f"[sweep] run_point f={c.n_faulty / N_MAIN:.2f}: rounds "
              f"{ref_pt.rounds_executed} mean_k {ref_pt.mean_k} decided "
              f"{ref_pt.decided_frac} trials/s {ref_pt.trials_per_sec:.3f}"
              f", equal to the batched point: {same}")
    if not ok:
        raise SystemExit("[sweep] the north star through the engine failed")

    # (b) bench.py:744-800's batched check: the per-point loop against one
    # dynamic bucket, the plain CF samplers, no kernel
    b_base = SimConfig(n_nodes=N_MAIN, n_faulty=0, trials=TRIALS,
                       delivery="quorum", scheduler="uniform",
                       path="histogram", max_rounds=SWEEP_ROUNDS, seed=SEED)
    fs = [int(fr * N_MAIN) for fr in SWEEP_FRACS]
    reset()
    fl = none().to(dev)
    per_point = []
    t0 = time.perf_counter()
    for f in fs:
        c = b_base.replace(n_faulty=f)
        r, fin = run_consensus(c, init_state(c, bal, fl), fl)
        per_point.append((r, *(v.cpu().numpy() for v in summarize_final(
            fin, fl.faulty, SWEEP_ROUNDS))))
        del fin
    torch.cuda.synchronize()
    per_point_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bcb = run_curve_batched(b_base, fs, initial_values=bal, faults_for=none,
                            device=dev)
    batched_s = time.perf_counter() - t0
    same = all(
        (r, float(dec), float(mk), float(ones), float(dis), kh.tolist())
        == (p.rounds_executed, p.decided_frac, p.mean_k, p.ones_frac,
            p.disagree_frac, p.k_hist.tolist())
        for (r, dec, mk, ones, kh, dis), p in zip(per_point, bcb.points))
    print(f"[sweep] batched check N={N_MAIN} T={TRIALS} fracs "
          f"{list(SWEEP_FRACS)} max_rounds {SWEEP_ROUNDS}: "
          f"{bcb.n_buckets} bucket {bcb.bucket_kinds}, rounds "
          f"{[p.rounds_executed for p in bcb.points]}, mean_k "
          f"{[p.mean_k for p in bcb.points]}; per-point {per_point_s:.4f} s, "
          f"batched {batched_s:.4f} s (wall_s {bcb.wall_s:.4f}); equal: "
          f"{same}; kernel launches {launches()}; {card}")
    if not same or bcb.bucket_kinds != ["dyn"] or launches():
        raise SystemExit("[sweep] the batched check failed")

    # (c) both lists in one journaled call (six buckets), the journal cut
    # after its third record with half a line after it, resumed serially
    # and pipelined
    cfgs = ns + [b_base.replace(n_faulty=f) for f in fs]
    with tempfile.TemporaryDirectory() as d:
        full_j, cut_j = Path(d) / "full.jsonl", Path(d) / "cut.jsonl"
        reset()
        full = run_points_batched(ns_base, cfgs, initial_values=bal,
                                  faults_for=none, journal_path=str(full_j),
                                  device=dev)
        full_launch = launches()
        # the JAX package's tests end a torn line with a newline too
        lines = full_j.read_text().splitlines()
        torn = lines[SWEEP_JOURNAL_CUT][:len(lines[SWEEP_JOURNAL_CUT]) // 2]
        cut_text = "\n".join(lines[:SWEEP_JOURNAL_CUT] + [torn]) + "\n"
        want_rounds = sum(p.rounds_executed
                          for p in full.points[SWEEP_JOURNAL_CUT:len(ns)])
        for pipeline in (False, True):
            cut_j.write_text(cut_text)
            reset()
            res = run_points_batched(ns_base, cfgs, initial_values=bal,
                                     faults_for=none,
                                     journal_path=str(cut_j), resume=True,
                                     pipeline=pipeline, device=dev)
            got = launches()
            round_launches = got.get("proposal_hist", 0) + \
                got.get("vote_commit", 0)
            same = ([sweep_science(p) for p in res.points]
                    == [sweep_science(p) for p in full.points])
            recs = sweep_records(full_j)
            same_recs = sweep_records(cut_j) == recs
            print(f"[sweep] journal resume (pipeline={pipeline}): "
                  f"{res.n_buckets} buckets, reused {res.bucket_reused}, "
                  f"round kernel launches {round_launches} (the rerun "
                  f"packed points' 2 x {want_rounds} rounds; the full run "
                  f"launched {full_launch}), points equal: {same}, journal "
                  f"records equal: {same_recs}, wall_s {res.wall_s:.4f} "
                  f"(full {full.wall_s:.4f})")
            reused = [i < SWEEP_JOURNAL_CUT for i in range(len(FRACS) + 1)]
            if (res.bucket_reused != reused or not same or not same_recs
                    or round_launches != 2 * want_rounds):
                raise SystemExit("[sweep] the journal resume failed")

        # (d) a checkpoint of the f = 0.45 run, resumed
        c = ns[-1]
        fl = none().to(dev)
        want_r, want = run_consensus(c, init_state(c, bal, fl), fl)
        cut = min(SWEEP_CKPT_ROUND, want_r)
        nxt, st = run_consensus_slice(
            c, start_state(c, init_state(c, bal, fl)), fl, 1, cut)
        path = Path(d) / "ckpt.npz"
        t0 = time.perf_counter()
        save_checkpoint(str(path), c, st, fl, nxt)
        t_save = time.perf_counter() - t0
        del st
        t0 = time.perf_counter()
        rounds, fin, _ = resume_from(str(path), device=dev)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        diff = trials_differing(fin, want)
        print(f"[sweep] checkpoint f=0.45 at round {nxt} of {want_r} "
              f"({path.stat().st_size / 2**20:.1f} MiB, save {t_save:.3f} s,"
              f" load + resume {t_resume:.3f} s): rounds {rounds}, trials "
              f"differing {diff} of {TRIALS}")
        if rounds != want_r or diff:
            raise SystemExit("[sweep] the checkpoint resume failed")
        del fin, want

    # (e) card against CPU at 8192 x 8: a mixed list (a fused static
    # bucket, a dynamic bucket), the coin comparison, the degree and
    # committee curves
    n_s, t_s = SWEEP_SMALL
    s_bal = balanced_inputs(t_s, n_s)
    s_base = SimConfig(n_nodes=n_s, n_faulty=0, trials=t_s,
                       max_rounds=MAX_ROUNDS, delivery="quorum",
                       scheduler="uniform", path="histogram", seed=SEED)
    mixed = [s_base.replace(n_faulty=int(0.40 * n_s), use_pallas_hist=True,
                            use_pallas_round=True),
             s_base.replace(n_faulty=int(0.25 * n_s)),
             s_base.replace(n_faulty=int(0.40 * n_s))]
    even = [f - (n_s - f) % 2 for f in (n_s // 10, n_s // 4, 2 * n_s // 5)]
    t_base = SimConfig(n_nodes=n_s, n_faulty=0, trials=t_s,
                       max_rounds=TOPO_MAX_ROUNDS, seed=SEED)
    runs = {
        "mixed": lambda d: [sweep_science(p) for p in run_points_batched(
            s_base, mixed, initial_values=s_bal,
            faults_for=lambda c: FaultSpec.none(t_s, n_s),
            device=d).points],
        "coins": lambda d: {k: [sweep_science(p) for p in v]
                            for k, v in coin_comparison_batched(
                                s_base, even, verbose=False,
                                device=d).items()},
        "degree": lambda d: degree_curve(
            t_base, list(SWEEP_DEGREE_SPECS), device=d),
        "committee": lambda d: committee_curve(
            t_base.replace(n_faulty=1), sizes=list(SWEEP_COMMITTEE_SIZES),
            committee_count=4, device=d)[0],
    }
    for name, run in runs.items():
        reset()
        t0 = time.perf_counter()
        got = run(dev)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        card_launch = launches()
        t0 = time.perf_counter()
        want = run("cpu")
        t_cpu = time.perf_counter() - t0
        print(f"[sweep] card vs cpu {name} N={n_s} T={t_s}: equal "
              f"{got == want} (card {t_card:.3f} s, cpu {t_cpu:.2f} s; "
              f"card kernel launches {card_launch})")
        if got != want:
            raise SystemExit(f"[sweep] {name}: card and CPU differ")
        if name == "mixed" and set(card_launch) != {"fused_round"}:
            raise SystemExit("[sweep] the mixed list's static bucket did "
                             "not run the fused kernel alone")
    reset()
    print(f"[sweep] kernel launches in the phase: {total}")
    print(f"[sweep] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [science] phase: the studies, the atlas, the auditor and the CLI
# on the card ----------------------------------------------------------------

SCIENCE_SMALL = (400, 4)    # card against CPU (the JAX package's toy size)
SCIENCE_CLOCKS = ("seconds", "trials_per_sec", "compile_count",
                  "oracle_msgs_per_sec")


def science_strip(doc):
    """A results / atlas document without what differs by design between
    the card and the CPU: the clocks and compile counts, the repro digest
    (it covers the config, whose use_pallas_* flags the card arms), the
    use_pallas_* fields and the file paths' directories."""
    import os
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in SCIENCE_CLOCKS or k in ("repro_digest", "digest") \
                    or k.startswith("use_pallas"):
                continue
            out[k] = (os.path.basename(v) if k in ("bundle", "repro")
                      and isinstance(v, str) else science_strip(v))
        return out
    if isinstance(doc, list):
        return [science_strip(v) for v in doc]
    return doc


class _Stamped:
    """A stdout that passes everything through and stamps each line that
    does not start with a space (a study's header) with the time it was
    printed."""

    def __init__(self, out):
        self.out, self.marks, self.text = out, [], ""

    def write(self, s):
        self.text += s
        for line in s.splitlines():
            if line and not line.startswith(" "):
                self.marks.append((time.perf_counter(), line))
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def science_files(out_dir) -> dict:
    """The witness bundles and repro documents a results run wrote."""
    import os
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(("witness_", "repro_")):
            with open(os.path.join(out_dir, name)) as fh:
                out[name] = science_strip(json.load(fh))
    return out


def science_phase(dev) -> None:
    """Phase 15: science and the CLI on the card.  (1) ``python -m
    benor_tpu_torch results --n 1000000 --trials 32`` in process, presets
    included: every study's lines and wall time, the round kernels'
    launches, the safety verdicts (violated strictly inside (0, N/2),
    intact at f = 0 and past N/2, the equivocator row violated, the odd
    rows violated iff N < 3F + 1), every balanced_curve point deciding,
    the forensics of every violating row (the break found where the
    watched ids hold both value camps), every repro replaying; (2)
    generate at N = 400 x 4 on the card equal to the CPU's; (3) the
    atlas's three searches with forensics on the card and on the CPU,
    equal, the CPU capture in band against ATLAS_BASELINE.json, each
    cliff audited clean and its repro replaying; ``atlas --searches
    quorum`` exiting 0 with the baseline-not-comparable note; (4)
    faults_curves at N = 1M x 32; (5) ``audit`` at N = 1M x 32, 0 on a
    crash config and 2 on the targeted adversary; (6) the baseline's
    three repros replayed through ``replay``, as on the CPU."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    from benor_tpu_torch import results
    from benor_tpu_torch.__main__ import main as cli
    from benor_tpu_torch.atlas import gate, manifest, repro
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sweep import baseline_configs
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    total = {}

    def launches():
        return {k: fn.launches for t in tables for k, fn in t.items()
                if fn.launches}

    def reset():
        for k, v in launches().items():
            total[k] = total.get(k, 0) + v
        for ops in (dk, hk, pr):
            ops.reset_launches()

    reset()
    total.clear()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "ATLAS_BASELINE.json")) as fh:
        baseline = json.load(fh)
    work = tempfile.mkdtemp(prefix="science_")

    # (1) the full-width studies through the CLI
    out_dir = os.path.join(work, "results")
    stamped = _Stamped(sys.stdout)
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped):
        rc = cli(["results", "--n", str(N_MAIN), "--trials", str(TRIALS),
                  "--out", out_dir])
    t_results = time.perf_counter() - t0
    study_launch = launches()
    marks = stamped.marks + [(t0 + t_results, "")]
    for (ta, line), (tb, _) in zip(marks, marks[1:]):
        print(f"[science] wall {tb - ta:.3f} s: {line}")
    with open(os.path.join(out_dir, "results.json")) as fh:
        res = json.load(fh)
    print(f"[science] results N={N_MAIN} T={TRIALS}: exit {rc}, "
          f"{t_results:.1f} s, kernel launches {study_launch}; {card}")
    ok = (rc == 0 and study_launch.get("proposal_hist", 0) > 0
          and study_launch.get("vote_commit", 0) > 0)
    bc = res["balanced_curve"]
    print(f"[science] balanced_curve decided "
          f"{[p['decided_frac'] for p in bc]} mean_k "
          f"{[p['mean_k'] for p in bc]} trials/s "
          f"{[round(p['trials_per_sec'], 3) for p in bc]}")
    ok = ok and all(p["decided_frac"] == 1.0 for p in bc)
    half = N_MAIN // 2
    size_watch = 4          # value-camp receivers per camp the watch holds
    for row in res["safety_violation"]:
        label = row["fault_model"]
        if label == "equivocate":
            want = True
        elif "odd" in label:
            want = "N<3F+1" in label
        else:
            want = 0 < row["f"] < half
        violated = row["disagree_frac"] > 0
        wa = row.get("witness_audit")
        free = row["f"] if label == "equivocate" else 0
        camps_watched = max(row["f"] + 1 - free, 1) <= size_watch
        found = wa is not None and wa["n_violations"] > 0
        print(f"[science] safety f={row['f']} {label}: disagree "
              f"{row['disagree_frac']} decided {row['decided_frac']:.4f} "
              f"(violated {violated}, want {want}); witness audit "
              f"{None if wa is None else wa['n_violations']} violations "
              f"(value camps inside the watched ids {camps_watched}), "
              f"repro {None if wa is None else wa.get('repro_reproduced')}")
        ok = ok and violated == want and (wa is not None) == violated
        if violated and camps_watched:
            ok = ok and found
    for row in res["disagreement"]:
        wa = row.get("witness_audit")
        print(f"[science] disagreement s={row['strength']}: disagree "
              f"{row['disagree_frac']} witness audit "
              f"{None if wa is None else wa['n_violations']} violations, "
              f"repro {None if wa is None else wa.get('repro_reproduced')}")
        ok = ok and (wa is not None) == (row["disagree_frac"] > 0)
    for key in ("safety_violation", "disagreement"):
        for row in res[key]:
            wa = row.get("witness_audit") or {}
            if "repro_reproduced" in wa:
                ok = ok and wa["repro_reproduced"] is True
    eq = res["equivocation"]
    print(f"[science] equivocation decided "
          f"{ {r['label']: r['decided_frac'] for r in eq} }")
    # the rows either side of the N > 3F bound: 3F < N decides, 3F > N not
    ok = ok and eq[1]["decided_frac"] == 1.0 and eq[2]["decided_frac"] == 0.0
    presets = [k for k in res if k.startswith("preset_")]
    print(f"[science] presets {presets}: trials/s "
          f"{[round(res[k]['trials_per_sec'], 3) for k in presets]}")
    ok = ok and len(presets) == sum(c.n_nodes <= N_MAIN for c in
                                    baseline_configs().values())
    # the oracle-parity study: its header, its two lines, its row
    head = "oracle<->scheduler distribution parity (N=100):"
    lines = stamped.text.splitlines()
    i = lines.index(head) if head in lines else -1
    study = lines[i + 1:i + 3] if i >= 0 else []
    op = res.get("oracle_parity", {})
    print(f"[science] oracle parity: {study}; order-invariant "
          f"{op.get('order_invariant_decided_runs')}, KS D "
          f"{op.get('ks_statistic')} p {op.get('ks_pvalue')}")
    ok = ok and len(study) == 2 and study[0].startswith(
        "  order-invariant (fifo==shuffle, decided): True") and \
        study[1].startswith("  rounds-to-decide: oracle") and \
        op.get("order_invariant_decided_runs") is True and \
        op.get("n_seeds") == max(8 * TRIALS, 256)
    if not ok:
        raise SystemExit("[science] the full-width studies failed a check")

    # (2) the card against the CPU at the JAX package's toy size, where
    # the quorum is within EXACT_TABLE_MAX and the flags are inert
    n_s, t_s = SCIENCE_SMALL
    small = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        sub = os.path.join(work, f"small_{tag}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            doc = results.generate(out_dir=sub, n_large=n_s,
                                   trials_large=t_s, presets=False,
                                   device=d)
        small[tag] = (
            science_strip({k: v for k, v in doc.items() if k != "meta"}),
            science_files(sub), time.perf_counter() - t0)
    same = small["card"][:2] == small["cpu"][:2]
    print(f"[science] card vs cpu generate N={n_s} T={t_s}: equal {same} "
          f"(card {small['card'][2]:.2f} s, cpu {small['cpu'][2]:.2f} s; "
          f"{len(small['card'][1])} bundles and repros)")
    if not same:
        raise SystemExit("[science] generate differs card vs cpu")

    # (3) the atlas: three searches with forensics, card and CPU
    caps = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        reset()
        t0 = time.perf_counter()
        caps[tag] = (manifest.capture_atlas(device=d),
                     time.perf_counter() - t0, launches())
    (g_doc, g_s, g_launch), (c_doc, c_s, _) = caps["card"], caps["cpu"]
    same = (science_strip(g_doc["searches"])
            == science_strip(c_doc["searches"]))
    findings = gate.compare_atlas(c_doc, baseline)
    print(f"[science] atlas card {g_s:.1f} s ({g_doc['probe_count']} "
          f"probes, launches {g_launch}), cpu {c_s:.1f} s: equal {same}; "
          f"cpu capture against ATLAS_BASELINE.json: "
          f"{[f.message for f in findings] or 'in band'}")
    ok = same and not findings
    for s in g_doc["searches"]:
        for c in s["cliffs"]:
            print(f"[science] atlas {s['name']}: cliff [{c['lo']:g}, "
                  f"{c['hi']:g}] {c['lo_verdict']}->{c['hi_verdict']}, "
                  f"audit_ok {c['safety']['audit_ok']}, repro "
                  f"{c['repro']['config']['trials']}x"
                  f"{c['repro']['config']['n_nodes']} reproduced "
                  f"{c['repro_reproduced']}")
            ok = ok and c["safety"]["audit_ok"] and c["repro_reproduced"]
    ok = ok and sorted(len(s["cliffs"]) for s in g_doc["searches"]) \
        == [1, 1, 1]
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["atlas", "--searches", "quorum"])
    note = "baseline not comparable" in err.getvalue()
    print(f"[science] atlas --searches quorum on the card: exit {rc}, "
          f"note {note}: {err.getvalue().strip()[:160]}")
    if not (ok and rc == 0 and note):
        raise SystemExit("[science] the atlas failed a check")

    # (4) the fault curves at full width
    reset()
    t0 = time.perf_counter()
    fc = results.faults_curves(N_MAIN, TRIALS, device=dev)
    torch.cuda.synchronize()
    t_fc = time.perf_counter() - t0
    n_pts = len(fc["drop_curve"]) + len(fc["churn_curve"])
    for row in fc["drop_curve"] + fc["churn_curve"]:
        print(f"[science] faults {row}")
    print(f"[science] faults_curves N={N_MAIN} T={TRIALS}: {n_pts} points "
          f"in {t_fc:.2f} s ({n_pts * TRIALS / t_fc:.3f} trials/s over "
          f"the call, each point run twice), drop buckets "
          f"{fc['drop_buckets']}, launches {launches()}")
    if fc["drop_buckets"] != 1 or not all(
            0 < r["decided_frac"] for r in fc["drop_curve"]):
        raise SystemExit("[science] faults_curves failed a check")

    # (5) the auditor at full width
    audits = {}
    for name, argv, want in (
            ("crash", ["--f", str(N_MAIN // 4)], 0),
            ("targeted", ["--f", "4", "--scheduler", "targeted",
                          "--balanced"], 2)):
        reset()
        t0 = time.perf_counter()
        rc = cli(["audit", "--n", str(N_MAIN), "--trials", str(TRIALS),
                  *argv])
        audits[name] = rc
        print(f"[science] audit {name} N={N_MAIN} T={TRIALS}: exit {rc} "
              f"(want {want}), {time.perf_counter() - t0:.2f} s, launches "
              f"{launches()}")
        if rc != want:
            raise SystemExit(f"[science] audit {name} exited {rc}")

    # (6) the baseline's repros through `replay`, as on the CPU
    for s in baseline["searches"]:
        doc = s["cliffs"][0]["repro"]
        path = os.path.join(work, f"repro_{s['name']}.json")
        repro.save_repro(path, doc)
        rc = cli(["replay", path])
        cpu = repro.replay_repro(doc, "cpu")
        card_res = repro.replay_repro(doc, dev)
        print(f"[science] replay {s['name']}: exit {rc}, card verdict "
              f"{card_res['verdict']}, recorded {doc['verdict']}; cpu "
              f"reproduced {cpu['ok']}")
        if rc != (0 if cpu["ok"] else 2) or card_res != cpu or \
                card_res["verdict"]["verdict"] != doc["verdict"]["verdict"]:
            raise SystemExit(f"[science] replay {s['name']} failed")
    reset()
    print(f"[science] kernel launches in the phase: {total}")
    print(f"[science] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [oracle] phase: the event-loop oracles, the HTTP node servers and
# the metrics registry ---------------------------------------------------------

# tests/test_native_oracle.py's scenarios: (n, f, seed, values, faulty)
ORACLE_SCENARIOS = (
    (5, 0, 0, [1] * 5, [False] * 5),
    (5, 1, 1, [1, 1, 1, 0, 0], [False] * 4 + [True]),
    (9, 4, 2, [1, 0, 1, 0, 1, 0, 1, 1, 0],
     [True, True, False, False, True, False, False, False, True]),
    (10, 5, 3, [1, 0] * 5, [True] * 5 + [False] * 5),
    (7, 2, 4, [0, 1, 1, 0, 1, 0, 1],
     [True, False, True, False, False, False, False]),
    (1, 0, 5, [1], [False]),
    (30, 9, 6, [i % 2 for i in range(30)], [True] * 9 + [False] * 21),
)
ORACLE_BATCH = (100, 40, 256)   # run_batch: N, F, seeds (oracle_parity's)
ORACLE_PARITY_TRIALS = TRIALS   # oracle_parity(32): 256 seeds and trials
# the served networks (the first F faulty; quorum delivery, so the round
# kernels serve): (name, N, F, inputs, launch overrides, base port); the
# start.ts demo's all-1 inputs, then alternating inputs, which take rounds
ORACLE_SERVED = (("start.ts demo", 10, 4, "ones", {}, 3000),
                 ("N=100 F=30 recorded", 100, 30, "alternating",
                  {"record": True, "poll_rounds": 1}, 3200))


def http_get(port, path):
    """GET one route of a node server -> (status code, body bytes,
    headers)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def http_post(port, path, body: bytes):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def served_run(n, f, inputs, kw, base, device):
    """A launch (the first F faulty) with the flagship flags, served on
    ``base``; /start, then every /status and
    /getState, polled after every slice where poll_rounds is set ->
    (answers, facade states, checks)."""
    from benor_tpu_torch import launch_network
    from benor_tpu_torch.backends.http_api import serve_network
    from benor_tpu_torch.results import FLAGSHIP_FLAGS
    faulty = [True] * f + [False] * (n - f)
    values = [1] * n if inputs == "ones" else [i % 2 for i in range(n)]
    net = launch_network(n, f, values, faulty, device=device,
                         max_rounds=32, delivery="quorum",
                         path="histogram", **FLAGSHIP_FLAGS, **kw)
    answers, cursors = [], []
    cluster = serve_network(net, base_port=base)
    try:
        before = [http_get(base + i, "/status")[:2] for i in range(n)]
        if kw.get("poll_rounds"):
            def poll():
                code, body, _ = http_get(
                    base, f"/getRoundHistory?since_round="
                          f"{cursors[-1] if cursors else -1}")
                doc = json.loads(body)
                cursors.append(doc["cursor"])
                answers.append([r["round"] for r in doc["rows"]])
                answers.append(http_get(base + n - 1, "/getState")[:2])
            net.start(on_slice=poll)
            started = http_get(base, "/start")[:2]   # idempotent
        else:
            started = http_get(base, "/start")[:2]
        status = [http_get(base + i, "/status")[:2] for i in range(n)]
        state = [http_get(base + i, "/getState") for i in range(n)]
        post = http_post(base + n - 1, "/message",
                         b'{"k": 1, "x": 1, "messageType": "proposal '
                         b'phase"}')
        history = (http_get(base, "/getRoundHistory")[:2]
                   if kw.get("record") else None)
    finally:
        cluster.close()
    facade = net.get_states()
    checks = {
        "status_before": [c for c, _ in before] == [500] * f + [200] * (n - f),
        "start": started == (200, b'{"message": "Algorithm started"}'),
        "status": [(c, b.decode()) for c, b in status]
        == [(code, body) for body, code in
            (net.status(i) for i in range(n))],
        "getState": [json.loads(b) for _, b, _ in state] == facade,
        "json": all(h.get("Content-Type") == "application/json"
                    for _, _, h in state),
        "post_405": post[0] == 405 and post[2].get("Allow") == "GET",
    }
    if kw.get("poll_rounds"):
        rounds = net.rounds_executed
        rows = json.loads(history[1])["rows"]
        checks["cursor"] = cursors == list(range(1, rounds + 1))
        checks["history"] = [r["round"] for r in rows] == \
            list(range(rounds + 1))
    answers += [before, started, status, [b for _, b, _ in state],
                post[:2], history]
    return answers, facade, checks, net.rounds_executed


def oracle_phase(dev) -> None:
    """Phase 16: the event-loop oracles, the HTTP node servers and the
    metrics registry.  (1) the native oracle, built from the checkout's
    copy of the C++ source, equal to the express oracle on
    tests/test_native_oracle.py's seven scenarios in both orders, then
    ``run_batch`` at N = 100 x 256 seeds; (2) ``oracle_parity(32)`` on the
    card: the simulator side's final state equal to the same call's on the
    CPU, decided runs order-invariant, the KS statistic and p-value; (3)
    ``serve_network`` over a card ``TpuNetwork`` with the flagship flags
    armed (the CF regime forced, so the fused kernel serves): the start.ts
    demo and N = 100, F = 30 with ``record=True, poll_rounds=1``, every
    answer equal to the facade's and to the CPU launch's, the cursor
    walking every round, POST /message 405, the fused kernel's launches;
    (4) ``trace --device cuda`` with ``--metrics-out``."""
    import contextlib
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from benor_tpu_torch import launch_network, results
    from benor_tpu_torch.__main__ import main as cli
    from benor_tpu_torch.backends import native_oracle
    from benor_tpu_torch.config import SimConfig
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.ops import sampling
    from benor_tpu_torch.utils import metrics
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]

    def launches():
        return {k: fn.launches for t in (dk.KERNELS, hk.KERNELS, pr.KERNELS)
                for k, fn in t.items() if fn.launches}

    # (1) the oracles on the host
    t0 = time.perf_counter()
    native_oracle.load_library()
    t_build = time.perf_counter() - t0
    same = []
    for n, f, seed, values, faulty in ORACLE_SCENARIOS:
        for order in ("fifo", "shuffle"):
            states = {}
            for backend in ("express", "native"):
                net = launch_network(n, f, values, faulty, backend=backend,
                                     seed=seed, max_rounds=12,
                                     oracle_order=order)
                net.start()
                states[backend] = net.get_states()
            same.append(states["express"] == states["native"])
    n_b, f_b, s_b = ORACLE_BATCH
    cfg_b = SimConfig(n_nodes=n_b, n_faulty=f_b, backend="native",
                      max_rounds=64, oracle_order="shuffle")
    vals_b, faulty_b = results._parity_scenario(n_b, f_b)
    t0 = time.perf_counter()
    out = native_oracle.run_batch(cfg_b, vals_b, faulty_b,
                                  np.arange(s_b, dtype=np.uint32),
                                  raise_on_cap=True)
    t_batch = time.perf_counter() - t0
    healthy = out["decided"][:, f_b:].all(axis=1)
    print(f"[oracle] native == express on {len(ORACLE_SCENARIOS)} "
          f"scenarios x 2 orders: {sum(same)}/{len(same)} (library "
          f"loaded in {t_build:.2f} s); run_batch N={n_b} F={f_b} x "
          f"{s_b} seeds: {t_batch * 1e3:.1f} ms, "
          f"{int(out['steps'].sum())} deliveries "
          f"({out['steps'].sum() / t_batch:.4g}/s), decided "
          f"{int(healthy.sum())}/{s_b}, tripped {out['n_tripped']}")
    if not all(same) or out["n_tripped"] or not healthy.any():
        raise SystemExit("[oracle] the native and express oracles differ")

    # (2) oracle parity with its simulator side on the card
    for ops in (dk, hk, pr):
        ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = results.oracle_parity(ORACLE_PARITY_TRIALS, device=dev)
    t_par = time.perf_counter() - t0
    fins = {d: results._parity_sim(ORACLE_PARITY_TRIALS, 0, 100, 40, d)
            for d in (dev, "cpu")}
    equal = all(torch.equal(getattr(fins[dev], a).cpu(),
                            getattr(fins["cpu"], a))
                for a in ("x", "decided", "k", "killed"))
    print(f"[oracle] oracle_parity({ORACLE_PARITY_TRIALS}) on the card: "
          f"{t_par:.2f} s, {res['n_seeds']} seeds, order-invariant "
          f"{res['order_invariant_decided_runs']}, rounds oracle "
          f"{res['oracle_round_hist']} vs card {res['tpu_round_hist']}, "
          f"KS D={res['ks_statistic']} p={res['ks_pvalue']}; the "
          f"simulator side card == cpu {equal}; {card}")
    if not (equal and res["order_invariant_decided_runs"]):
        raise SystemExit("[oracle] oracle_parity failed a check")

    # (3) the node servers over the card's network, flagship flags armed
    for ops in (dk, hk, pr):
        ops.reset_launches()
    old = sampling.EXACT_TABLE_MAX
    sampling.EXACT_TABLE_MAX = 4          # the CF regime: the kernels serve
    total_fused = 0
    try:
        for name, n, f, inputs, kw, base in ORACLE_SERVED:
            t0 = time.perf_counter()
            got = served_run(n, f, inputs, kw, base, dev)
            t_card = time.perf_counter() - t0
            # a recorded run takes the armed twin (its own counter)
            fused = pr.fused_round.launches + pr.fused_round.obs_launches
            others = {k: v for k, v in launches().items()
                      if k != "fused_round"}
            cpu = served_run(n, f, inputs, kw, base + 500, "cpu")
            equal = got[:2] == cpu[:2] and got[3] == cpu[3]
            print(f"[oracle] serve_network {name}: rounds {got[3]}, "
                  f"checks {got[2]}, card == cpu {equal}, fused_round "
                  f"launches {fused} (armed {pr.fused_round.obs_launches})"
                  f", other kernels {others}, {t_card:.2f} s")
            if not (all(got[2].values()) and equal and fused == got[3]
                    and not others):
                raise SystemExit(f"[oracle] serve_network {name} failed")
            for ops in (dk, hk, pr):
                ops.reset_launches()
            total_fused += fused
    finally:
        sampling.EXACT_TABLE_MAX = old

    # (4) trace on the card with the registry's two exports
    work = tempfile.mkdtemp(prefix="oracle_")
    docs = {}
    for ext in ("jsonl", "prom"):
        metrics.REGISTRY.reset()
        trace = os.path.join(work, f"trace_{ext}.json")
        mpath = os.path.join(work, f"metrics.{ext}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli(["trace", "--n", "1000", "--f", "250", "--trials",
                      str(TRIALS), "--out", trace, "--metrics-out", mpath])
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        with open(mpath) as fh:
            docs[ext] = fh.read()
        rounds = [e for e in events if e.get("tid") == "rounds"]
        host = [e for e in events if e.get("tid") == "host"]
        print(f"[oracle] trace --device cuda --metrics-out {ext}: exit "
              f"{rc}, {len(events)} events ({len(rounds)} round slices, "
              f"{len(host)} host spans), {time.perf_counter() - t0:.2f} s; "
              f"{buf.getvalue().splitlines()[0]}")
        if rc != 0 or not rounds or [e["name"] for e in host] != \
                ["trace.run"]:
            raise SystemExit("[oracle] trace failed a check")
    recs = [json.loads(ln) for ln in docs["jsonl"].splitlines()]
    ok = ([(r["name"], r["type"], r["count"]) for r in recs]
          == [("trace.run", "timer", 1)]
          and "benor_tpu_trace_run_count 1" in docs["prom"].splitlines())
    print(f"[oracle] metrics: jsonl {recs[0]['name']} count "
          f"{recs[0]['count']}, prom {len(docs['prom'].splitlines())} "
          f"lines: ok {ok}")
    if not ok:
        raise SystemExit("[oracle] the metrics exports failed a check")
    print(f"[oracle] fused_round launches in the phase: {total_fused}")
    print(f"[oracle] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [profile] phase: the performance observatory -----------------------

# the kernel captures' scales beyond CAPTURE_SCALE: the one-pass cap and
# the main path's width
PROFILE_KERNEL_SCALES = ((8192, 32), (N_MAIN, 32))


def profile_phase(dev) -> None:
    """Phase 17: perfscope, kernelscope and the sweep manifest on the card.
    (1) ``profile --device cuda`` at 1M x 32 x 16 in process: each
    regime's first and steady execution, peak MiB, busy share, the port's
    kernel launches and top device entries; ``fused_vs_xla`` bit-equal,
    its speedup; (2) ``profile --kernels --device cuda`` at CAPTURE_SCALE,
    every counter and per-tile row equal to the CPU capture's; then the
    capture at 8192 x 32 (the one-pass cap) and 1M x 32: active + pad lanes
    = T x Np x rounds a stage, telemetry off == on, each dispatch's device
    ms a round, predicted bytes and ops and share of the bound; (3) the
    sweep manifest at 9000 x 4 (pipelined): buckets, points and science
    equal to the CPU capture's, the stage clocks telescoping within the
    gate's bands on both, one bucket span with its four stages a bucket.
    The kernels' launches are read around the phase."""
    import contextlib
    import io
    import os
    import tempfile
    from benor_tpu_torch.__main__ import main as cli
    from benor_tpu_torch.kernelscope import capture_kernels
    from benor_tpu_torch.kernelscope.capture import CAPTURE_SCALE
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sweepscope import capture_sweep_manifest
    from benor_tpu_torch.sweepscope import gate as sgate
    from benor_tpu_torch.utils.metrics import SPANS
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    dk.reset_launches()
    hk.reset_launches()
    pr.reset_launches()

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        return rc, buf.getvalue()

    # (1) perfscope at the card's profile scale
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "perf.json")
        t0 = time.perf_counter()
        rc, _ = run_cli(["profile", "--device", "cuda", "--profile-out",
                         path])
        t_cli = time.perf_counter() - t0
        with open(path) as fh:
            doc = json.load(fh)
    sc = doc["scale"]
    print(f"[profile] perfscope N={sc['n_nodes']} T={sc['trials']} "
          f"R<={sc['max_rounds']}: exit {rc} in {t_cli:.1f} s ({card})")
    for name, r in doc["regimes"].items():
        print(f"[profile] {name}: rounds {r['rounds_executed']}, build "
              f"{r['compile_s']:.4f} s ({r['backend_compiles']} library "
              f"event(s)), first {r['first_execute_s']:.6f} s, steady "
              f"{r['steady_execute_s']:.6f} s, peak "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB, busy "
              f"{r['device_busy_s']:.6f} s = {r['device_busy_share']:.4f} "
              f"of steady, launches {r['kernel_launches']}, top "
              f"{r['top_device'][:3]}")
    fvx = doc["fused_vs_xla"]
    print(f"[profile] fused_vs_xla: {fvx['counts_mode']} one_pass "
          f"{fvx['one_pass']} against {fvx['baseline_path']}: bit_equal "
          f"{fvx['bit_equal']}, packed {fvx['fused_steady_execute_s']} s, "
          f"unfused {fvx['xla_steady_execute_s']} s, speedup "
          f"{fvx['speedup']}")
    if (rc != 0 or sorted(doc["regimes"]) != sorted(
            ("traced", "fused_pallas", "sliced", "batched_sweep"))
            or not fvx["bit_equal"] or fvx["interpret_mode"]
            or any(r["rounds_executed"] < 1 or r["device_busy_s"] is None
                   for r in doc["regimes"].values())
            or not doc["regimes"]["fused_pallas"]["kernel_launches"]):
        raise SystemExit("[profile] perfscope failed a check")

    # (2) kernelscope: CAPTURE_SCALE card == CPU, then the larger scales
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kernels.json")
        rc, _ = run_cli(["profile", "--kernels", "--device", "cuda",
                         "--profile-out", path])
        with open(path) as fh:
            card_k = json.load(fh)["kernels"]
    cpu_k = capture_kernels(device="cpu")["kernels"]
    same = sorted(card_k) == sorted(cpu_k) and all(
        card_k[k]["stages"] == cpu_k[k]["stages"]
        and card_k[k]["rounds_executed"] == cpu_k[k]["rounds_executed"]
        for k in cpu_k)
    print(f"[profile] kernelscope N={CAPTURE_SCALE['n_nodes']} "
          f"T={CAPTURE_SCALE['trials']}: cli exit {rc}, counters and "
          f"per-tile rows card == cpu {same}")
    if rc != 0 or not same:
        raise SystemExit("[profile] kernelscope at CAPTURE_SCALE failed")
    for n, t in PROFILE_KERNEL_SCALES:
        t0 = time.perf_counter()
        man = capture_kernels(n_nodes=n, trials=t, device="cuda")
        for name, rep in man["kernels"].items():
            g, r = rep["geometry"], rep["rounds_executed"]
            lanes = {s: b["counters"]["active_lanes"]
                     + b["counters"]["pad_lanes"]
                     for s, b in rep["stages"].items()}
            dv = rep["device"]
            print(f"[profile] {name} N={n} T={t} [{rep['dispatch']}]: "
                  f"rounds {r}, lanes a stage {lanes} (T x Np x rounds "
                  f"{t * g['np_total'] * r}), off == on "
                  f"{rep['bit_equal_off_on']}, device "
                  f"{dv['device_ms_per_round']:.4f} ms a round "
                  f"{dv['launches']}, predicted "
                  f"{dv['predicted_kernel_bytes_per_round']} B and "
                  f"{dv['predicted_ops_per_round']:.0f} ops a round, "
                  f"{dv['bytes_per_s']:.4g} B/s, {dv['ops_per_s']:.4g} "
                  f"op/s, bound {dv['bound_ms_per_round']:.4f} ms "
                  f"({dv['bound_by']}), share {dv['bound_share']:.4f} "
                  f"({card})")
            if (not rep["bit_equal_off_on"] or r < 1
                    or any(v != t * g["np_total"] * r
                           for v in lanes.values())
                    or not dv["launches"]):
                raise SystemExit(f"[profile] {name} at N={n} failed a check")
        print(f"[profile] kernels N={n} T={t}: "
              f"{time.perf_counter() - t0:.1f} s")

    # (3) the sweep manifest, card against the CPU
    SPANS.clear()
    SPANS.enable()
    try:
        man = {d: capture_sweep_manifest(pipeline=True, device=d)
               for d in ("cuda", "cpu")}
        spans = SPANS.snapshot()
    finally:
        SPANS.disable()
        SPANS.clear()

    def shape(m):
        return [(b["kind"], b["size"], b["point_indices"])
                for b in m["buckets"]]

    science = {d: [sweep_science(p) for p in cb.points]
               for d, (_, cb) in man.items()}
    tel = {d: (m["telescoping"]["coverage"], sgate.telescope_max(m))
           for d, (m, _) in man.items()}
    buckets = [sp for sp in spans if sp.name.startswith("sweep.bucket[")]
    kids = [sum(1 for c in spans if c.parent_id == b.span_id)
            for b in buckets]
    m = man["cuda"][0]
    print(f"[profile] sweep manifest {m['scale']}: buckets "
          f"{shape(m)} (cpu {shape(man['cpu'][0])}), science card == cpu "
          f"{science['cuda'] == science['cpu']}, coverage / band max "
          f"card {tel['cuda']} cpu {tel['cpu']}, wall {m['wall_s']} s, "
          f"headroom {m['overlap_headroom_s']} s, reclaimed "
          f"{m['pipeline']['headroom_reclaimed_frac']}, spans "
          f"{len(buckets)} buckets x {kids} stages")
    if (shape(m) != shape(man["cpu"][0])
            or science["cuda"] != science["cpu"]
            or any(not sgate.TELESCOPE_MIN <= cov <= hi
                   for cov, hi in tel.values())
            or kids != [4] * len(buckets)
            or len(buckets) != 2 * m["n_buckets"]):
        raise SystemExit("[profile] the sweep manifest failed a check")
    got = {k: fn.launches for t in tables for k, fn in t.items()
           if fn.launches}
    print(f"[profile] launches in the phase: {got}, armed "
          f"{pr.obs_launch_counts()}")
    if not (got.get("proposal_hist") and got.get("vote_commit")
            and got.get("fused_round")):
        raise SystemExit("[profile] a round kernel was never launched")
    print(f"[profile] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [serve] phase: the request plane ----------------------------------

SERVE_LOAD_CLIENTS = 1000       # the committed baseline's scale
SERVE_N, SERVE_T = 1 << 16, 32  # the default per-job cap on N, 32 trials
SERVE_SMALL = (8192, 8)         # the card-vs-CPU scale
SERVE_F = 0.45
SERVE_BIG = N_MAIN              # the private instance's north-star width
#: clocks and the job plumbing, which differ between two runs by design
SERVE_CLOCKS = ("seconds", "trials_per_sec", "job", "batch_jobs")


def serve_sse(app, doc, timeout=600.0) -> list:
    """POST one job document with ?stream=sse and read its stream to the
    terminal done -> [(event, data)]."""
    import socket
    body = json.dumps(doc).encode()
    buf = b""
    with socket.create_connection((app.host, app.port),
                                  timeout=timeout) as s:
        s.sendall(b"POST /v1/jobs?stream=sse HTTP/1.1\r\nHost: x\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        while b"event: done" not in buf:
            got = s.recv(1 << 16)
            if not got:
                break
            buf += got
    if not buf.startswith(b"HTTP/1.1 200"):
        raise SystemExit(f"[serve] POST {doc} answered {buf[:200]!r}")
    out = []
    for block in buf.partition(b"\r\n\r\n")[2].split(b"\n\n"):
        ev = dict(line.partition(b": ")[::2] for line in block.split(b"\n"))
        if b"event" in ev:
            out.append((ev[b"event"].decode(), json.loads(ev[b"data"])))
    return out


def serve_direct(doc, device, limits=None) -> tuple:
    """A job document run directly: the result ``run_point`` of its
    config gives, its recorder rows and its witness rows and verdict."""
    from benor_tpu_torch.audit import (WitnessBundle, audit_witness,
                                       witness_rows)
    from benor_tpu_torch.serve import JobSpec, result_dict
    from benor_tpu_torch.state import witness_node_ids
    from benor_tpu_torch.sweep import default_crash_faults, run_point
    from benor_tpu_torch.utils.metrics import round_history_rows
    rows = wit = blob = None
    out = []
    for spec in JobSpec.from_dict(doc, limits=limits).expand():
        cfg = spec.to_config()
        pt = run_point(cfg, device=device)
        res = {k: v for k, v in result_dict(pt, spec).items()
               if k not in SERVE_CLOCKS}
        if pt.round_history is not None:
            rows = round_history_rows(pt.round_history)
        if pt.witness is not None:
            wit = witness_rows(pt.witness, cfg.witness_trials,
                               witness_node_ids(cfg))
            rep = audit_witness(WitnessBundle.from_run(
                cfg, pt.witness, faults=default_crash_faults(cfg, device)))
            blob = {"ok": rep.ok, "violations": len(rep.violations),
                    "summary": rep.summary()}
            res["audit"] = blob
        out.append(res)
    return out, rows, wit, blob


def serve_jobs(n, t) -> dict:
    """The four job kinds at N = n x t, f = SERVE_F, quorum delivery on
    the histogram path; the sweep over the north star's f grid."""
    base = {"n_nodes": n, "n_faulty": int(SERVE_F * n), "trials": t,
            "max_rounds": MAX_ROUNDS, "delivery": "quorum",
            "path": "histogram", "seed": 7}
    return {"simulate": {**base, "kind": "simulate"},
            "sweep": {**base, "kind": "sweep",
                      "f_values": [int(fr * n) for fr in FRACS]},
            "trajectory": {**base, "kind": "trajectory", "seed": 8},
            "audit": {**base, "kind": "audit", "seed": 9}}


def serve_check(app, tag, docs, device, limits=None) -> bool:
    """Post each job and hold it against its direct run on ``device``."""
    ok = True
    for kind, doc in docs.items():
        t0 = time.perf_counter()
        events = serve_sse(app, doc)
        t_serve = time.perf_counter() - t0
        results = [{k: v for k, v in p.items() if k not in SERVE_CLOCKS}
                   for e, p in events if e == "result"]
        rows = [p for e, p in events if e == "round"]
        wit = [p for e, p in events if e == "witness"]
        blob = [p for e, p in events if e == "audit"]
        want, wrows, wwit, wblob = serve_direct(doc, device, limits)
        same = (results == want
                and (kind != "trajectory" or rows == wrows)
                and (kind != "audit" or (wit == wwit and blob == [wblob])))
        ok = ok and same and bool(results)
        print(f"[serve] {tag} {kind} N={doc['n_nodes']} T={doc['trials']}: "
              f"{len(results)} result(s) in {t_serve:.3f} s, rounds "
              f"{[r['rounds_executed'] for r in results]}, decided "
              f"{[r['decided_frac'] for r in results]}, round rows "
              f"{len(rows)}, witness rows {len(wit)}, verdict "
              f"{blob[0]['summary'] if blob else None}; equal to run_point "
              f"on {device}: {same}")
    return ok


def serve_phase(dev) -> None:
    """Phase 18: the request plane on the card.  (1) ``load --device cuda
    --clients 1000`` in process at DEFAULT_JOB: the manifest's jobs/s,
    p50 / p99, jobs a launch, attribution and executor builds; (2) a
    ServeApp on the card at the default limits: the four job kinds at
    the per-job cap (65,536 x 32) equal to run_point on the card, and at
    8192 x 8 equal to run_point on the CPU; (3) a private instance with
    n_nodes lifted: 1M x 32 at f = 0.45 equal to run_point on the card;
    (4) the hand-written kernels' launches in the phase."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    from benor_tpu_torch.__main__ import main as cli
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.perfscope.capture import PORT_KERNELS
    from benor_tpu_torch.serve import DEFAULT_JOB, Batcher, ServeApp
    from benor_tpu_torch.sim import device_identity
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    tables = (dk.KERNELS, hk.KERNELS, pr.KERNELS)
    for ops in (dk, hk, pr):
        ops.reset_launches()

    # (1) the load test at the committed baseline's scale
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.json")
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["load", "--device", str(dev), "--clients",
                      str(SERVE_LOAD_CLIENTS), "--profile-out", path])
        t_load = time.perf_counter() - t0
        with open(path) as fh:
            m = json.load(fh)
    lat, attr, st = m["latency_ms"], m["attribution"], m["stages"]
    print(f"[serve] load --clients {m['clients']} ({m['platform']}, "
          f"{m['device_kind']}): exit {rc} in {t_load:.1f} s; jobs "
          f"{m['jobs_completed']}/{m['jobs_submitted']} errors "
          f"{m['errors']} in {m['duration_s']} s = "
          f"{m['throughput_jobs_per_sec']} jobs/s; latency p50 "
          f"{lat['p50']} ms p99 {lat['p99']} ms; {m['launches']} launches, "
          f"{m['jobs_per_launch']} jobs a launch; executor_compiles "
          f"{m['executor_compiles']}; attribution coverage "
          f"{attr['coverage']} ok {attr['ok']}; stage p99 ms "
          f"{ {k: v['p99'] for k, v in st.items()} }; {card}")
    for line in out.getvalue().splitlines() + err.getvalue().splitlines():
        print(f"[serve]   {line}")
    if (rc != 0 or m["errors"] or m["platform"] != device_identity(dev)[0]
            or m["jobs_completed"] != SERVE_LOAD_CLIENTS
            or m["executor_compiles"] != 0 or not attr["ok"]
            or m["jobs_per_launch"] <= 1.0):
        raise SystemExit("[serve] the load test failed a check")
    # the launch layer alone: one full batch of DEFAULT_JOB slots through
    # Batcher.step on this thread, no request plane beside it
    b = Batcher(start=False, device=dev)
    times = []
    for r in range(3):
        for i in range(b.max_batch_jobs):
            b.submit_dict({**DEFAULT_JOB, "seed": 1000 * r + i})
        t0 = time.perf_counter()
        b.step()
        times.append(time.perf_counter() - t0)
    print(f"[serve] batcher alone: {b.max_batch_jobs} DEFAULT_JOB slots "
          f"a step in {[round(t, 4) for t in times]} s, "
          f"{median(times) / b.max_batch_jobs * 1e3:.3f} ms a slot "
          f"(median); {card}")
    for i in range(b.max_batch_jobs):
        b.submit_dict({**DEFAULT_JOB, "seed": 5000 + i})
    breakdown("serve", f"one step of {b.max_batch_jobs} DEFAULT_JOB slots",
              b.step, median(times), PORT_KERNELS, torch_ops=True)

    # (2) the four kinds on the card's request plane
    ok = True
    with ServeApp(device=dev) as app:
        torch.cuda.reset_peak_memory_stats()
        ok &= serve_check(app, "cap", serve_jobs(SERVE_N, SERVE_T), dev)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ok &= serve_check(app, "small", serve_jobs(*SERVE_SMALL), "cpu")
        st = app.batcher.stats()
    print(f"[serve] ServeApp on the card: {st['jobs_completed']} jobs, "
          f"{st['launches']} launches, {st['executors']} executors, "
          f"executor_compiles {st['executor_compiles']}, batch_errors "
          f"{st['batch_errors']}; peak {peak:.1f} MiB at the cap; {card}")
    if not ok or st["batch_errors"]:
        raise SystemExit("[serve] a served job differs from run_point")

    # (3) the private instance at the north star's width
    doc = {"kind": "simulate", "n_nodes": SERVE_BIG,
           "n_faulty": int(SERVE_F * SERVE_BIG), "trials": TRIALS,
           "max_rounds": MAX_ROUNDS, "delivery": "quorum",
           "path": "histogram", "seed": 11}
    lifted = {"n_nodes": SERVE_BIG}
    with ServeApp(device=dev, limits=lifted) as app:
        torch.cuda.reset_peak_memory_stats()
        ok = serve_check(app, "private", {"simulate": doc}, dev, lifted)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[serve] private instance N={SERVE_BIG}: peak {peak:.1f} MiB")
    if not ok:
        raise SystemExit("[serve] the private instance failed a check")

    got = {k: fn.launches for t in tables for k, fn in t.items()
           if fn.launches}
    print(f"[serve] hand-written kernel launches in the phase: {got} (a "
          f"served job arms no kernel flag)")
    print(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")


# --- the [heartbeat] phase: the progress heartbeat ---------------------------

HB_CLOCKS = ("ts", "elapsed_s", "rounds_per_sec", "eta_s")


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def hb_nonclock(rec) -> dict:
    """A heartbeat record with its clocks reduced to present / null."""
    return {k: (v is None) if k in HB_CLOCKS else v for k, v in rec.items()}


def hb_network(n, t, hb, path, device):
    """The sliced network at N = n x t, f = SERVE_F, balanced inputs, the
    flagship flags, one round a slice -> (network, seconds, round-kernel
    launches)."""
    from benor_tpu_torch import launch_network
    from benor_tpu_torch.ops import packed_round as pr
    f = int(SERVE_F * n)
    pr.reset_launches()
    net = launch_network(n, f, [i % 2 for i in range(n)],
                         [True] * f + [False] * (n - f), device=device,
                         trials=t, max_rounds=MAX_ROUNDS, delivery="quorum",
                         scheduler="uniform", path="histogram",
                         use_pallas_hist=True, use_pallas_round=True,
                         poll_rounds=1, heartbeat_rounds=hb)
    net.heartbeat_path = path
    t0 = time.perf_counter()
    net.start()
    sync(device)
    secs = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in pr.KERNELS.items()
                if fn.launches}
    return net, secs, launched


def hb_sweep(n, t, path, device) -> list:
    """The north star's six points through run_points_batched with a
    heartbeat file: the five balanced zero-crash points, then the iid
    point with crash faults from birth -> the two curves."""
    from benor_tpu_torch import SimConfig
    from benor_tpu_torch.state import FaultSpec
    from benor_tpu_torch.sweep import balanced_inputs, run_points_batched
    base = SimConfig(n_nodes=n, n_faulty=0, **{**MAIN_RUN, "trials": t},
                     heartbeat_rounds=1)
    bal = balanced_inputs(t, n)
    five = run_points_batched(
        base, [base.replace(n_faulty=int(fr * n)) for fr in FRACS],
        initial_values=bal, faults_for=lambda c: FaultSpec.none(t, n),
        heartbeat_path=path, device=device)
    iid = base.replace(n_faulty=int(0.20 * n))
    one = run_points_batched(iid, [iid], heartbeat_path=path,
                             device=device)
    return [five, one]


def heartbeat_phase(dev) -> None:
    """Phase 19: the progress heartbeat.  (1) the 1M x 32 sliced network
    with a beat a round against the run without: final state, rounds and
    round-kernel launches equal; (2) the north star's six points through
    run_points_batched with a heartbeat file, one beat a bucket; (3)
    ``watch --no-follow`` on the file in its own process, exit 0; (4) the
    network and the sweep at 8192 x 8 card against CPU, every record
    equal but its clocks."""
    import os
    import tempfile
    import torch
    from benor_tpu_torch.meshscope import read_heartbeats
    from benor_tpu_torch.ops import _build
    from benor_tpu_torch.ops import dense as dk
    from benor_tpu_torch.ops import hist as hk
    from benor_tpu_torch.ops import packed_round as pr
    from benor_tpu_torch.sweep import summarize_final
    t_phase = time.perf_counter()
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    work = tempfile.mkdtemp(prefix="heartbeat_")
    total = {}              # the phase's launches (hb_network resets pr's)

    def tally_launches():
        for t in (dk.KERNELS, hk.KERNELS, pr.KERNELS):
            for k, fn in t.items():
                if fn.launches:
                    total[k] = total.get(k, 0) + fn.launches
        for ops in (dk, hk, pr):
            ops.reset_launches()

    tally_launches()
    total.clear()

    # (1) the sliced network, heartbeat off and on (the kernel library
    # loaded first, so neither run carries its build)
    _build.load_library()
    path = os.path.join(work, "net.jsonl")
    runs = {}
    for hb in (0, 1):
        runs[hb] = hb_network(N_MAIN, TRIALS, hb, path if hb else None, dev)
        tally_launches()
    (off, s_off, l_off), (on, s_on, l_on) = runs[0], runs[1]
    same = (off.rounds_executed == on.rounds_executed and l_off == l_on
            and all(torch.equal(getattr(off.state, a), getattr(on.state, a))
                    for a in ("x", "decided", "k", "killed")))
    beats = read_heartbeats(path)
    summ = [float(v) for v in summarize_final(
        on.state, on.faults.faulty, MAX_ROUNDS)[:2]]
    print(f"[heartbeat] network N={N_MAIN} T={TRIALS} f={SERVE_F} "
          f"poll_rounds=1: rounds {on.rounds_executed}, decided "
          f"{summ[0]:.6f}, off {s_off:.3f} s / on {s_on:.3f} s, round-"
          f"kernel launches off {l_off} on {l_on}, off == on {same}; "
          f"{len(beats)} beats: "
          f"{[(b['round'], b['decided_frac'], b['done']) for b in beats]}"
          f"; rounds/s {[b['rounds_per_sec'] for b in beats]}; {card}")
    if (not same or (dev.type == "cuda" and not l_on)
            or len(beats) != on.rounds_executed + 1
            or not beats[-1]["done"]
            or beats[-1]["round"] != on.rounds_executed):
        raise SystemExit("[heartbeat] the sliced network failed a check")
    del off, on, runs

    # (2) the north star through the engine with a heartbeat file
    path = os.path.join(work, "sweep.jsonl")
    t0 = time.perf_counter()
    curves = hb_sweep(N_MAIN, TRIALS, path, dev)
    t_sweep = time.perf_counter() - t0
    tally_launches()
    beats = read_heartbeats(path)
    n_buckets = sum(cb.n_buckets for cb in curves)
    shown = [(b["bucket_index"], b["points_done"], b["points_total"],
              b["done"]) for b in beats]
    rounds = [p.rounds_executed for cb in curves for p in cb.points]
    print(f"[heartbeat] north star N={N_MAIN} T={TRIALS}: "
          f"{n_buckets} buckets in {t_sweep:.1f} s, {len(beats)} beats: "
          f"{shown}; rounds {rounds}")
    if len(beats) != n_buckets or [b["done"] for b in beats] != \
            [False] * 4 + [True, True]:
        raise SystemExit("[heartbeat] not one beat a bucket")

    # (3) watch on the file, in its own process
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "benor_tpu_torch", "watch", path,
         "--no-follow", "--keep-going", "--timeout", "5"], cwd=here,
        capture_output=True, text=True, timeout=120)
    lines = proc.stdout.splitlines()
    print(f"[heartbeat] watch --no-follow: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.2f} s, {len(lines)} lines, last "
          f"{lines[-1] if lines else None!r}")
    if proc.returncode != 0 or len(lines) != len(beats):
        raise SystemExit("[heartbeat] watch failed")

    # (4) card against CPU at 8192 x 8
    n_s, t_s = SERVE_SMALL
    recs = {}
    for d in (dev, "cpu"):
        pn = os.path.join(work, f"net_{d}.jsonl")
        ps = os.path.join(work, f"sweep_{d}.jsonl")
        net = hb_network(n_s, t_s, 1, pn, d)[0]
        tally_launches()
        cbs = hb_sweep(n_s, t_s, ps, d)
        tally_launches()
        recs[str(d)] = ([hb_nonclock(r) for r in read_heartbeats(pn)],
                        [hb_nonclock(r) for r in read_heartbeats(ps)],
                        net.rounds_executed,
                        [sweep_science(p) for cb in cbs for p in cb.points])
    equal = recs[str(dev)] == recs["cpu"]
    print(f"[heartbeat] N={n_s} T={t_s}: network beats "
          f"{len(recs['cpu'][0])}, sweep beats {len(recs['cpu'][1])}, "
          f"records, rounds and points card == cpu {equal}")
    if not equal:
        raise SystemExit("[heartbeat] card and CPU records differ")
    print(f"[heartbeat] kernel launches in the phase: {total}, armed "
          f"{pr.obs_launch_counts()}")
    print(f"[heartbeat] phase {time.perf_counter() - t_phase:.1f} s")


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
