"""The card's peaks, the packing cost model, the port's traffic model and
the roofline placement (port of benor_tpu/perfscope/roofline.py).

The peak table holds the card the port is measured on, one NVIDIA H100
(NVIDIA's data sheet, SXM part, at its 700 W limit): its HBM bandwidth and
its f32 rate outside the tensor cores, at which every operation of the
op-count model below is charged.  The JAX package's TPU rows do not carry
over.  The CPU is off the table: its peaks are None and a placement there
has no bound.

``packing_report`` is the JAX package's arithmetic over ``PACK_LAYOUT``
unchanged.  ``kernel_geometry`` / ``stage_traffic`` price the port's own
round kernels: the plane-stack passes and the count operands as the JAX
package prices them, and the partial term by the port's launch geometry
(int32 rows a trial: one per block of the two-kernel pair's one-wave grid,
one on the fused kernel, whose cluster reduces a trial in place, and one on
the plain versions) instead of the Pallas kernels' 128 int16 columns a tile.

``roofline`` divides the least time the work could take, the larger of its
bytes over the bandwidth and its operations over the f32 rate, by the
measured time, and says which of the two it used: the round kernels are
bound by their operations on this card.
"""

from __future__ import annotations

from typing import Optional

#: One H100's HBM bandwidth, bytes/s, and f32 rate outside the tensor
#: cores, op/s (NVIDIA's data sheet, SXM part, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def peaks_for(device_kind: str):
    """(bytes/s, op/s) of a device kind (``torch.cuda.get_device_name``):
    the H100's, or (None, None) off the table."""
    if "h100" in device_kind.lower():
        return HBM_BYTES_PER_S, F32_OPS_PER_S
    return None, None


# Operations the kernels need on a run's inputs, counted from
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
#  - the round kernels need a CF pair only for the lanes that read it, the
#    coin only for lanes that coin; the dense tally does three integer adds
#    an edge (one per class).
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


#: HBM bytes a node per round of the pre-bit-plane layout: the int32-word
#: pair read the word in the proposal kernel, read it again in the vote
#: kernel and wrote the new word (roofline.py:57-65).
UNPACKED_WORD_ROUND_BYTES = 12.0

#: Bits the old layout spent a node (one int32 word).
UNPACKED_WORD_BITS = 32


def packed_bits_per_node(max_rounds: int) -> int:
    """Hot-state bits a node under the bit-plane layout: the static planes
    and the k planes ``max_rounds`` needs."""
    from ..state import PACK_STATIC_WIDTH, pack_k_bits_for

    return PACK_STATIC_WIDTH + pack_k_bits_for(max_rounds)


def packed_round_bytes_per_node(max_rounds: int) -> float:
    """HBM bytes the single-pass round moves a node per round: one read and
    one write of the plane stack."""
    return 2.0 * packed_bits_per_node(max_rounds) / 8.0


def packing_report(max_rounds: int) -> dict:
    """The packing cost model as manifest numbers (roofline.py:82-103):
    old-layout over new-layout bytes a node per round, and the share of
    the old 32-bit word the hot state needs."""
    bits = packed_bits_per_node(max_rounds)
    new_bytes = packed_round_bytes_per_node(max_rounds)
    return {
        "packed_bits_per_node": bits,
        "packed_round_bytes_per_node": round(new_bytes, 4),
        "unpacked_round_bytes_per_node": UNPACKED_WORD_ROUND_BYTES,
        "packed_traffic_ratio": round(UNPACKED_WORD_ROUND_BYTES
                                      / new_bytes, 4),
        "packing_efficiency": round(bits / UNPACKED_WORD_BITS, 4),
    }


#: What the geometry's partial term prices (the block names it).
PARTIAL_PRICED = ("int32 rows a trial a stage: blocks of the two-kernel "
                  "pair's one-wave grid, 1 on the fused kernel and on the "
                  "plain versions")


def kernel_geometry(cfg, partial_rows: Optional[dict] = None) -> dict:
    """The packed round's geometry for the traffic model: the padded node
    axis, the stage-counter tiles (``telemetry_tiles``), the planes
    (``pack_width``), whether the fused kernel serves, and the partial
    outputs the port's launches write: ``partial_rows`` (stage -> int32
    rows a trial; default 1 a stage, the fused kernel's and the plain
    versions') of ``partial_stage_cols`` columns each.  ``partial_cols``
    is the two stages' columns together and ``partial_dtype_bytes`` their
    int32 width."""
    from ..ops.packed_round import (PROP_COLS, VOTE_COLS,
                                    fused_one_pass_eligible,
                                    telemetry_tiles)
    from ..ops.stream import TILE_N
    from ..state import pack_width

    t, n = cfg.trials, cfg.n_nodes
    np_total = n + (-n) % TILE_N
    one_pass = fused_one_pass_eligible(cfg, t, n)
    rows = {"proposal": 1, "vote": 1}
    if partial_rows is not None and not one_pass:
        rows = {s: int(partial_rows[s]) for s in rows}
    return {
        "trials": t,
        "n_nodes": n,
        "np_total": np_total,
        "tiles": telemetry_tiles(cfg, t, n),
        "tile_nodes": np_total if one_pass else TILE_N,
        "planes": pack_width(cfg),
        "partial_cols": PROP_COLS + VOTE_COLS,
        "partial_dtype_bytes": 4,
        "one_pass": bool(one_pass),
        "partial_rows": rows,
        "partial_stage_cols": {"proposal": PROP_COLS, "vote": VOTE_COLS},
        "partial_priced": PARTIAL_PRICED,
    }


def traffic_terms(geom: dict) -> dict:
    """The byte terms of one round, from a ``kernel_geometry`` dict alone:

      plane             one pass over the plane stack:
                        T x planes x (np_total / 32) x 4
      counts            the [T] count operands (3 classes, f32)
      partial_<stage>   a stage's partial output: rows x T x cols x 4

    ``plane`` and ``counts`` are the JAX package's terms."""
    t = geom["trials"]
    out = {"plane": t * geom["planes"] * (geom["np_total"] // 32) * 4,
           "counts": t * 3 * 4}
    for stage in ("proposal", "vote"):
        out[f"partial_{stage}"] = (geom["partial_rows"][stage] * t
                                   * geom["partial_stage_cols"][stage]
                                   * geom["partial_dtype_bytes"])
    return out


def stage_traffic(geom: dict) -> dict:
    """Predicted HBM bytes a round a stage (roofline.py:142-176's
    composition on the port's terms): the proposal stage reads the stack
    and writes its partials; the vote stage writes the new stack (and on
    the two-kernel pair reads it afresh first) and writes its partials;
    ``reduce`` reads the pair's partials back for the sums over blocks,
    which the fused kernel does inside its cluster (0 there)."""
    terms = traffic_terms(geom)
    plane, counts = terms["plane"], terms["counts"]
    vote_plane_passes = 1 if geom["one_pass"] else 2
    stages = {
        "proposal": plane + terms["partial_proposal"] + counts,
        "vote": (vote_plane_passes * plane + terms["partial_vote"]
                 + counts),
        "reduce": (0 if geom["one_pass"]
                   else terms["partial_proposal"] + terms["partial_vote"]),
    }
    stages["total"] = sum(stages.values())
    return stages


def traffic_report(cfg, partial_rows: Optional[dict] = None) -> dict:
    """The traffic model of one packed-round config: the geometry, its
    byte terms and the predicted bytes a round a stage.  No executable
    cost model exists for a sequence of torch ops and kernel launches, so
    nothing here is measured."""
    geom = kernel_geometry(cfg, partial_rows=partial_rows)
    return {
        "geometry": geom,
        "predicted_terms": traffic_terms(geom),
        "predicted_bytes_per_round": stage_traffic(geom),
    }


def roofline(bytes_moved: float, exec_s: float, device_kind: str,
             ops: Optional[float] = None) -> dict:
    """Place measured work on the card's roofline:

      bytes_per_s / ops_per_s   the work over the measured seconds
      bound_s                   the larger of bytes / the bandwidth and
                                (with an op count) ops / the f32 rate
      bound_by                  'bytes' | 'operations': which was larger
      bound_share               bound_s / exec_s

    Off the peak table (the CPU) the bound keys are None."""
    bw, rate = peaks_for(device_kind)
    out = {
        "bytes_per_s": (bytes_moved / exec_s) if exec_s > 0 else None,
        "ops_per_s": (ops / exec_s) if (ops is not None and exec_s > 0)
        else None,
        "hbm_peak_bytes_per_s": bw,
        "ops_peak_per_s": rate,
        "bound_s": None,
        "bound_by": None,
        "bound_share": None,
    }
    if bw is None:
        return out
    t_bytes = bytes_moved / bw
    t_ops = ops / rate if ops is not None else 0.0
    out["bound_s"] = max(t_bytes, t_ops)
    out["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    if exec_s > 0:
        out["bound_share"] = out["bound_s"] / exec_s
    return out
