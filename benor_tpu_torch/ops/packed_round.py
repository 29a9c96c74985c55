"""Fused Ben-Or rounds over BIT-PLANE packed node state
(port of benor_tpu/ops/pallas_round.py: every counts regime, coin and fault
model of its packed round).

One round is either ONE kernel or TWO, exactly where the JAX package
dispatches them (``fused_one_pass_eligible``):

  fused_round    — both phases in one pass, a thread-block cluster per
                   trial: proposal tallies -> majority -> vote histogram
                   and quorum gate through the cluster's shared memory ->
                   vote tallies + coin + decide/adopt/commit -> the new
                   plane stack.
  proposal_hist  — the two-kernel path's proposal pass (per-block vote
  vote_commit      histogram + alive count, summed here between the two
                   launches), then the vote pass + commit.

The counts modes (``tally.pallas_round_counts_mode``): 'sampled' draws each
lane's tallies in-kernel from the phase's class histogram (the CF pair, or
under 'equivocate' the mixed-population tally with its second stream at
phase + 64 and the live equivocators ``n_equiv``); 'delivered' broadcasts
the adversarial scheduler's closed-form counts; 'camps' picks the targeted
adversary's camp triple by global node id.  The coins: private, common (the
trial's shared bit) and weak_common (the private bit where the lane's
deviation uniform is below eps, else the shared bit).  Under 'equivocate'
the vote histograms count honest live lanes only; the alive count keeps
the equivocators.  Under 'crash_at_round' and 'crash_recover' each lane's
crash and recover rounds (int32 [T, Np] operands, ``pad_fault_rounds``)
are held against the round at the start of both passes: the killed plane
latches the crashed lanes, the down plane stores this round's down lanes
(crash_recover; alive = not killed and not down), and under the amnesia
rejoin an undecided lane at its first round back restarts from "?".  The
next round's proposal histogram then changes with the round, so the loop
recomputes it from the plane stack every round (``sent_hist_from_pack``).

Each wrapper launches its hand-written CUDA kernel (csrc/round_body.cuh,
built by csrc/round_kernels.cu and csrc/round_b2.cu) on a CUDA tensor and
counts the launch in its ``launches`` attribute; on a CPU tensor it runs
its plain torch version, which the tests hold against the JAX package's
Pallas kernels and ``chip_smoke.py`` holds against the kernel on the card.
Any other device raises.

The observability planes (SimConfig.record, witness_trials,
kernel_telemetry; pallas_round.py's ``record`` / ``witness_ids`` /
``telemetry``) ride the kernels' armed twins (built by csrc/round_obs.cu
and csrc/round_obs_b2.cu, counted in ``obs_launches``): the vote pass adds
the flight recorder's columns (VOTE_RECORD_LAYOUT), each watched lane
writes its witness fields, and the stage counters (TELEM_COLS) are added
per 512-lane tile.  The unarmed kernels are the code they were.

The plane stack is a [T, planes, Np/32] tensor of 32-bit words stored as
torch.int32 (the bit pattern is what counts; the kernels read uint32).
Plain-version bit work runs in int64 masked to 32 bits.  All randomness
keys on the global (node, trial) counters, so tiling never moves a bit and
the fused round equals proposal + sum + vote bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import VAL0, VAL1, VALQ
from ..faults.recovery import REJOIN_MODES, rejoin_mode
from ..state import (NetState, PACK_COINED, PACK_DECIDED, PACK_DOWN,
                     PACK_FAULTY, PACK_K, PACK_KILLED, PACK_LAYOUT,
                     PACK_NODES_PER_WORD, PACK_STATIC_WIDTH, PACK_X,
                     pack_k_bits)
from . import hist as hist_ops
from . import rng, tally
from .launch import check, count_vecs, on_cpu, ptr, raise_on, stream
from .stream import (TILE_N, _COIN_SALT, _EQUIV_SALT_OFFSET, cf_pair_draws,
                     equiv_pair_draws, lane_ids, stream_scal)

#: Single-pass engage caps, kept from the JAX package so both dispatch alike.
FUSED_ONE_PASS_MAX_NODES = 8192
FUSED_ONE_PASS_MAX_LANES = 1 << 18

#: The fused kernel's grid choices (csrc/round_kernels.cu kFusedClusters,
#: kFusedWarpChoices, kFusedKeep): blocks a trial's cluster, warps a block,
#: and the most words a warp holds across the phase barrier.
FUSED_CLUSTERS = (1, 2, 4, 8, 16)
FUSED_WARPS = (16, 8, 4)
FUSED_KEEP = 4

#: Per-block partial-column layouts — name -> (base, width), the JAX
#: package's tables verbatim.  The kernels write only these columns.
PROP_PARTIAL_LAYOUT = {
    "vote_hist": (0, 3),    # cols 0-2: sent-vote class histogram 0/1/"?"
    "alive": (3, 1),        # alive count (quorum gate / n_alive)
}
VOTE_PARTIAL_LAYOUT = {
    "next_hist": (0, 3),    # cols 0-2: next round's proposal histogram
    "settled": (3, 1),
    "unsettled": (4, 1),    # the loop predicate
}
#: The recorder's columns, appended by the vote pass under ``record``, one
#: a state.REC_LAYOUT column in its order: sums over lanes but the margin,
#: a max (``killed`` counts the pad lanes, which the round assembly takes
#: off).
VOTE_RECORD_LAYOUT = {
    "decided": (5, 1),
    "killed": (6, 1),
    "undecided_0": (7, 1),
    "undecided_1": (8, 1),
    "undecided_q": (9, 1),
    "coin_flips": (10, 1),
    "tally_margin": (11, 1),
}
#: The witness fields each watched node adds to a pass's columns, in
#: state.WIT_LAYOUT's names: the proposal pass's after its base columns,
#: the vote pass's after its base and recorder columns (``_witb_base``).
WITNESS_PROP_FIELDS = ("p0", "p1")
WITNESS_VOTE_FIELDS = ("x", "decided", "killed", "coined", "v0", "v1")
#: The stage counters (SimConfig.kernel_telemetry), name -> (offset, width)
#: in a [tiles, TELEM_WIDTH] block a stage, each summed over trials per
#: 512-lane tile: real and pad lanes, lanes the sampler drew for (0 under
#: the closed-form counts), lanes the histograms counted, lanes past the
#: quorum gate and lanes that took a coin (vote stage), and the stage's
#: plane-stack passes (read 1, read + write 2 on the pair; 1 and 1 on the
#: fused kernel).
TELEM_COLS = {
    "active_lanes": (0, 1),
    "pad_lanes": (1, 1),
    "sampler_draws": (2, 1),
    "hist_visits": (3, 1),
    "quorum_passes": (4, 1),
    "coin_draws": (5, 1),
    "plane_hops": (6, 1),
}
TELEM_WIDTH = max(b + w for b, w in TELEM_COLS.values())
TELEM_COLUMNS = tuple(sorted(TELEM_COLS, key=lambda c: TELEM_COLS[c][0]))
#: The stage axis of the telemetry accumulator.
TELEM_STAGES = ("proposal", "vote")


def _extent(*layouts) -> int:
    """One past the last column of the union of layout tables."""
    return max(b + w for lay in layouts for b, w in lay.values())


PROP_COLS = _extent(PROP_PARTIAL_LAYOUT)
VOTE_COLS = _extent(VOTE_PARTIAL_LAYOUT)
VOTE_OBS_COLS = _extent(VOTE_PARTIAL_LAYOUT, VOTE_RECORD_LAYOUT)
_WITA_BASE = PROP_COLS
_WITA_PER_NODE = len(WITNESS_PROP_FIELDS)
_WITB_PER_NODE = len(WITNESS_VOTE_FIELDS)
_RP = {name: base for name, (base, _) in VOTE_RECORD_LAYOUT.items()}


def _witb_base(record: bool) -> int:
    """The vote pass's first witness column: after its base columns and,
    under ``record``, the recorder's."""
    return VOTE_OBS_COLS if record else VOTE_COLS


def _telem_base(stage: str, record: bool, n_witness: int) -> int:
    """A stage's first TELEM_COLS column in the JAX kernels' per-tile
    partial layout (after everything else the stage emits).  The port's
    kernels and plain versions return the counters as blocks of their own;
    this keeps the layout the tests hold the two packages' tables to."""
    if stage == "proposal":
        return _WITA_BASE + _WITA_PER_NODE * n_witness
    return _witb_base(record) + _WITB_PER_NODE * n_witness

_X_BITS = PACK_LAYOUT["x"][1]
_M32 = 0xFFFFFFFF
_FAULT_MODELS = ("crash", "byzantine", "equivocate", "crash_at_round",
                 "crash_recover")
#: The kernels' mode ids (csrc/round_kernels.cu kSampled.., kPrivate..,
#: and FaultRounds: 0, kStatic, for the other fault models).
COUNTS_MODES = ("sampled", "delivered", "camps")
COIN_MODES = ("private", "common", "weak_common")
FAULT_ROUNDS = {"crash_at_round": 1, "crash_recover": 2}


def fused_one_pass_eligible(cfg, trials: int, n_nodes: int) -> bool:
    """True iff packed_round takes the single-pass kernel for this
    (config, shape): sampled counts and the padded node axis within the
    caps."""
    if tally.pallas_round_counts_mode(cfg) != "sampled":
        return False
    np_total = n_nodes + (-n_nodes) % TILE_N
    return (np_total <= FUSED_ONE_PASS_MAX_NODES
            and trials * np_total <= FUSED_ONE_PASS_MAX_LANES)


def telemetry_tiles(cfg, trials: int, n_nodes: int) -> int:
    """Rows of a stage's telemetry block: 1 where the fused kernel runs (one
    tile, the whole padded node axis), else Np / 512."""
    if fused_one_pass_eligible(cfg, trials, n_nodes):
        return 1
    return (n_nodes + (-n_nodes) % TILE_N) // TILE_N


# --------------------------------------------------------------------------
# Bit-plane pack / unpack.
# --------------------------------------------------------------------------


def _words_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Per-lane 0/1 int64 [T, Np] -> int32 [T, Np/32] words (bit j = lane
    j of the word), two's-complement for words >= 2**31."""
    t, n = bits.shape
    j = torch.arange(PACK_NODES_PER_WORD, dtype=torch.int64,
                     device=bits.device)
    w = (bits.reshape(t, n // PACK_NODES_PER_WORD, PACK_NODES_PER_WORD)
         << j).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _pack_planes(kbits, x, decided, killed, faulty, k, coined, down=None):
    """Per-lane int64 fields [T, Np] -> the plane stack int32
    [T, PACK_STATIC_WIDTH + kbits, Np/32]; the down plane is ``down``
    (crash_recover: this round's down lanes, write-only evidence), else
    0."""
    planes = [None] * (PACK_STATIC_WIDTH + kbits)
    for b in range(_X_BITS):
        planes[PACK_X + b] = (x >> b) & 1
    planes[PACK_DECIDED] = decided
    planes[PACK_KILLED] = killed
    planes[PACK_COINED] = coined
    planes[PACK_FAULTY] = faulty
    planes[PACK_DOWN] = (torch.zeros_like(decided) if down is None
                         else down.to(torch.int64))
    for b in range(kbits):
        planes[PACK_K + b] = (k >> b) & 1
    return torch.stack([_words_from_bits(p) for p in planes], dim=1)


def pack_state(cfg, state: NetState, faulty: torch.Tensor) -> torch.Tensor:
    """NetState leaves + faulty mask -> padded plane stack int32
    [T, state.pack_width(cfg), Np/32].  Pad lanes carry the killed bit and
    x = "?"; every other pad plane is 0, as is the coin-commit plane."""
    n = state.x.shape[-1]
    n_pad = (-n) % TILE_N

    def lanes(a, pad_const):
        a = a.to(torch.int64)
        if n_pad:
            a = torch.nn.functional.pad(a, (0, n_pad), value=pad_const)
        return a

    x = lanes(state.x, VALQ)
    dec = lanes(state.decided, 0)
    return _pack_planes(pack_k_bits(cfg), x, dec, lanes(state.killed, 1),
                        lanes(faulty, 0), lanes(state.k, 0),
                        torch.zeros_like(dec))


def plane_field(pack: torch.Tensor, base: int, width: int) -> torch.Tensor:
    """One PACK_LAYOUT field of a plane stack -> int64 [T, Np] per-lane
    values (node order: word-major, bit = in-word lane)."""
    t, _, n_w = pack.shape
    j = torch.arange(PACK_NODES_PER_WORD, dtype=torch.int64,
                     device=pack.device)
    val = torch.zeros((t, n_w, PACK_NODES_PER_WORD), dtype=torch.int64,
                      device=pack.device)
    for b in range(width):
        word = pack[:, base + b, :].to(torch.int64) & _M32
        val = val | (((word[..., None] >> j) & 1) << b)
    return val.reshape(t, n_w * PACK_NODES_PER_WORD)


def unpack_state(pack: torch.Tensor, n_nodes: int) -> NetState:
    """Plane stack -> NetState (pad lanes dropped)."""
    kb = pack.shape[1] - PACK_STATIC_WIDTH
    x = plane_field(pack, PACK_X, _X_BITS)[:, :n_nodes]
    dec = plane_field(pack, PACK_DECIDED, 1)[:, :n_nodes]
    kil = plane_field(pack, PACK_KILLED, 1)[:, :n_nodes]
    k = plane_field(pack, PACK_K, kb)[:, :n_nodes]
    return NetState(x=x.to(torch.int8), decided=dec.to(torch.bool),
                    k=k.to(torch.int32), killed=kil.to(torch.bool))


# --------------------------------------------------------------------------
# Per-lane pieces shared by the plain versions (JAX pallas_round.py:466-689).
# --------------------------------------------------------------------------


def pad_fault_rounds(cfg, faults, np_total):
    """(crash_round, recover_round) int32 [T, np_total], padded with 0 (pad
    lanes never crash and carry the killed bit anyway): the operands the
    kernels re-derive liveness from.  (None, None) for the static fault
    models, (cr, None) under crash_at_round, (cr, rec) under
    crash_recover."""
    def pad(a):
        a = a.to(torch.int32)
        n_pad = np_total - a.shape[-1]
        if n_pad:
            a = torch.nn.functional.pad(a, (0, n_pad))
        return a.contiguous()

    if cfg.fault_model == "crash_at_round":
        return pad(faults.crash_round), None
    if cfg.fault_model == "crash_recover":
        if faults.recover_round is None:
            raise ValueError(
                "fault_model='crash_recover' needs FaultSpec.recover_round "
                "(faults.recovery.crash_recover_faults builds it from the "
                "SimConfig.recovery spec)")
        return pad(faults.crash_round), pad(faults.recover_round)
    return None, None


def _bounds_update(fault_model, rejoin, r, cr, rcv, x, decided, killed,
                   faulty):
    """The crash-at-round / crash-recover update of round ``r`` on per-lane
    fields (JAX pallas_round.py:466-504) -> (x, killed, down or None):
    under 'crash_at_round' a faulty lane with 0 < cr <= r latches killed;
    under 'crash_recover' a lane whose interval started latches killed if it
    never rejoins (rcv <= 0) and is down while r < rcv, and with the
    'amnesia' rejoin an undecided lane at r == rcv restarts x from "?".
    ``decided`` is read under amnesia only."""
    down = None
    if fault_model == "crash_at_round":
        crashing = (faulty == 1) & (cr > 0) & (r >= cr)
        killed = torch.where(crashing, 1, killed)
    elif fault_model == "crash_recover":
        started = (faulty == 1) & (cr > 0) & (r >= cr)
        killed = torch.where(started & (rcv <= 0), 1, killed)
        down = started & (rcv > 0) & (r < rcv)
        if rejoin == "amnesia":
            rj = ((faulty == 1) & (cr > 0) & (rcv > 0) & (r == rcv)
                  & (decided == 0))
            x = torch.where(rj, VALQ, x)
    return x, killed, down


def _load_fields(pack, freeze, r=0, cr=None, rcv=None, fault_model="crash",
                 rejoin="durable"):
    """Plane stack (and the round bounds of round ``r``) -> per-lane (x,
    decided, killed, faulty, k) int64, the (alive, frozen) masks and this
    round's down mask (None but under crash_recover), [T, Np] each;
    ``killed`` is the latched word the store keeps."""
    kbits = pack.shape[1] - PACK_STATIC_WIDTH
    x = plane_field(pack, PACK_X, _X_BITS)
    decided = plane_field(pack, PACK_DECIDED, 1)
    killed = plane_field(pack, PACK_KILLED, 1)
    faulty = plane_field(pack, PACK_FAULTY, 1)
    k = plane_field(pack, PACK_K, kbits)
    x, killed, down = _bounds_update(fault_model, rejoin, r, cr, rcv, x,
                                     decided, killed, faulty)
    alive = killed == 0
    if down is not None:
        alive = alive & ~down
    frozen = (decided == 1) if freeze else torch.zeros_like(alive)
    return x, decided, killed, faulty, k, alive, frozen, down


def _sent(fault_model, vote, faulty):
    """Byzantine lanes broadcast bit-flipped values (0 <-> 1, "?" kept)."""
    if fault_model == "byzantine":
        flip = torch.where(vote == VAL0, VAL1,
                           torch.where(vote == VAL1, VAL0, vote))
        return torch.where(faulty == 1, flip, vote)
    return vote


def _honest(fault_model, alive, faulty):
    """The histograms' population: under 'equivocate' the live honest
    lanes (an equivocator's values are drawn receiver-side or chosen by the
    adversary), else every live lane."""
    if fault_model == "equivocate":
        return alive & (faulty == 0)
    return alive


def sent_hist_from_pack(cfg, pack: torch.Tensor, cr=None, rec=None,
                        r=1) -> torch.Tensor:
    """The proposal histogram int32 [T, 3] of the values the honest live
    lanes send in round ``r`` (byzantine lanes flipped) — the first round's
    input to the kernels, and every round's under 'crash_at_round' /
    'crash_recover', whose liveness (and under amnesia x) changes with the
    round: the same update as the kernels' on the round bounds ``cr`` /
    ``rec`` (``pad_fault_rounds``)."""
    x = plane_field(pack, PACK_X, _X_BITS)
    killed = plane_field(pack, PACK_KILLED, 1)
    faulty = plane_field(pack, PACK_FAULTY, 1)
    rejoin = rejoin_mode(cfg.recovery)
    decided = (plane_field(pack, PACK_DECIDED, 1)
               if cfg.fault_model == "crash_recover" and rejoin == "amnesia"
               else None)
    x, killed, down = _bounds_update(cfg.fault_model, rejoin, r, cr, rec, x,
                                     decided, killed, faulty)
    alive = killed == 0
    if down is not None:
        alive = alive & ~down
    return tally.class_histogram(_sent(cfg.fault_model, x, faulty),
                                 _honest(cfg.fault_model, alive, faulty))


def _popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & _M32) >> 24


def n_equiv_from_pack(cfg, pack: torch.Tensor):
    """Live equivocators a trial, int32 [T] — run-constant under
    'equivocate' (the killed and faulty planes never change), so the loop
    computes it once — or None for every other fault model: a bit count of
    the faulty & ~killed plane words."""
    if cfg.fault_model != "equivocate":
        return None
    live_eqv = (pack[:, PACK_FAULTY, :].to(torch.int64)
                & ~pack[:, PACK_KILLED, :].to(torch.int64)) & _M32
    return _popcount32(live_eqv).sum(-1).to(torch.int32)


def unsettled_from_pack(pack: torch.Tensor) -> torch.Tensor:
    """Lanes neither decided nor killed, summed over every trial (pad lanes
    carry the killed bit, so they never count)."""
    dec = plane_field(pack, PACK_DECIDED, 1)
    kil = plane_field(pack, PACK_KILLED, 1)
    return ((dec | kil) == 0).sum()


# --------------------------------------------------------------------------
# Plain versions of the three kernels.
# --------------------------------------------------------------------------


def kernel_vecs(hist: torch.Tensor, counts_mode: str) -> torch.Tensor:
    """A phase's counts as the kernels' count operand, f32 contiguous: the
    [T, 3] class histogram ('sampled'); the two value classes of the
    adversary's [T, 3] delivered counts ('delivered'; "?" never enters the
    majority or decide math); the value classes of the [T, 3, 3] camp
    triples, camp-major, [T, 6] ('camps')."""
    f = hist.to(torch.float32)
    if counts_mode == "delivered":
        f = f[:, :2]
    elif counts_mode == "camps":
        f = f[:, :, :2].reshape(f.shape[0], 6)
    return f.contiguous()


def _has_eq(fault_model, counts_mode) -> bool:
    """True iff the kernels draw the equivocate regime's mixed-population
    tallies: equivocators under sampled counts."""
    return fault_model == "equivocate" and counts_mode == "sampled"


def _tallies(seed, r, phase, vecs, shape, device, m, counts_mode, n_equiv,
             camp_b0, camp_b1):
    """Each lane's two tallies (class 0, class 1) of a phase, f32 [T, Np]
    (or [T, 1] where every lane of a trial has the same): the CF pair, the
    mixed-population tally where ``n_equiv`` is given (pallas_round.py
    _mixed_draws), the delivered counts, or the camp triple chosen by
    global node id against the camp bounds (_camp_select)."""
    if counts_mode == "delivered":
        return vecs[:, 0:1], vecs[:, 1:2]
    if counts_mode == "camps":
        node, _ = lane_ids(shape[0], shape[1], device)
        in1 = node >= camp_b1
        in0 = (node >= camp_b0) & ~in1
        a = torch.where(in1, vecs[:, 2:3],
                        torch.where(in0, vecs[:, 0:1], vecs[:, 4:5]))
        b = torch.where(in1, vecs[:, 3:4],
                        torch.where(in0, vecs[:, 1:2], vecs[:, 5:6]))
        return a, b
    if n_equiv is not None:
        n0, n1, _ = equiv_pair_draws(
            m, stream_scal(seed, r, phase),
            stream_scal(seed, r, phase + _EQUIV_SALT_OFFSET), vecs,
            count_vecs(n_equiv), shape, device)
        return n0, n1
    return cf_pair_draws(m, stream_scal(seed, r, phase), vecs, shape, device)


def _coin(seed, r, shape, device, coin_mode, eps, shared):
    """Each lane's coin, int64 [T, Np] (pallas_round.py _decide_commit):
    the histogram round's private or weak coin on the same stream (the
    plain versions of ops/hist.py), or the trial's shared bit (common)."""
    if coin_mode == "common":
        return shared.to(torch.int64)[:, None].expand(shape)
    if coin_mode == "private":
        coin = hist_ops.coin_flips_plain(seed, r, shape[0], shape[1], device)
    else:
        coin = hist_ops.weak_coin_flips_plain(seed, r, shape[0], shape[1],
                                              eps, shared)
    return coin.to(torch.int64)


def _witness_cols(witness_ids, n_local, fields) -> torch.Tensor:
    """The witness columns of a pass -> int32 [T, k * len(fields)]: for each
    watched global node id, its lane's value of each field (a tally cast to
    int32), or 0 where the id is no real lane (local index >= n_local)."""
    t = fields[0].shape[0]
    cols = []
    for wid in witness_ids:
        for f in fields:
            # a [T, 1] field holds the same value for every lane of a trial
            lane = f[:, wid if f.shape[1] > 1 else 0]
            cols.append(lane.to(torch.int32) if wid < n_local
                        else torch.zeros(t, dtype=torch.int32,
                                         device=f.device))
    return torch.stack(cols, dim=1)


def _telem_block(shape, n_local, tile, sampled, hops, hon=None,
                 quorum=None, coined=None) -> torch.Tensor:
    """A stage's counters per ``tile`` lanes, summed over trials -> int32
    [Np / tile, TELEM_WIDTH] in TELEM_COLS order.  Pad lanes are told by
    local index (>= n_local), never by a plane; a mask left None counts
    0."""
    t, np_total = shape
    tiles = np_total // tile
    dev = hon.device
    real = (torch.arange(np_total, device=dev) < n_local).reshape(tiles,
                                                                  tile)
    active = real.sum(1, dtype=torch.int32) * t

    def count(mask):
        if mask is None:
            return torch.zeros(tiles, dtype=torch.int32, device=dev)
        return mask.expand(shape).reshape(t, tiles, tile).sum(
            (0, 2), dtype=torch.int32)

    def full(v):
        return torch.full((tiles,), v, dtype=torch.int32, device=dev)

    vals = {"active_lanes": active, "pad_lanes": t * tile - active,
            "sampler_draws": full(t * tile if sampled else 0),
            "hist_visits": count(hon), "quorum_passes": count(quorum),
            "coin_draws": count(coined), "plane_hops": full(t * hops)}
    return torch.stack([vals[c] for c in TELEM_COLUMNS], dim=1)


def _proposal_pass(seed, r, phase, hist, pack, m, fault_model, freeze,
                   n_equiv, counts_mode, camp_b0, camp_b1, crash_round,
                   recover_round, rejoin):
    """The proposal pass on every lane -> (int32 [T, PROP_COLS], the
    histograms' lane mask, the lanes' tallies p0 and p1)."""
    x, decided, killed, faulty, k, alive, frozen, _ = _load_fields(
        pack, freeze, r, crash_round, recover_round, fault_model, rejoin)
    p0, p1 = _tallies(seed, r, phase, kernel_vecs(hist, counts_mode),
                      x.shape, pack.device, m, counts_mode,
                      n_equiv if _has_eq(fault_model, counts_mode) else None,
                      camp_b0, camp_b1)
    x1 = torch.where(p0 > p1, VAL0, torch.where(p1 > p0, VAL1, VALQ))
    vote = _sent(fault_model, torch.where(frozen, x, x1), faulty)
    hon = _honest(fault_model, alive, faulty)
    alive_n = alive.sum(1, dtype=torch.int32)[:, None]
    return (torch.cat([tally.class_histogram(vote, hon), alive_n], dim=1),
            hon, p0, p1)


def proposal_hist_plain(seed, r, phase, hist, pack, m, fault_model, freeze,
                        n_equiv=None, counts_mode="sampled", camp_b0=0,
                        camp_b1=0, crash_round=None, recover_round=None,
                        rejoin="durable", witness_ids=(), n_local=0,
                        telemetry=None):
    """Plain version of the proposal kernel -> int32 [T, PROP_COLS]: the
    vote-class histogram over honest live lanes (cols 0-2) and the alive
    count, then for each of ``witness_ids`` (global node ids) its lane's p0
    and p1.  ``hist`` is the phase's counts in ``counts_mode``'s layout
    ([T, 3] histogram or delivered counts, [T, 3, 3] camp triples);
    ``crash_round`` / ``recover_round`` the round bounds int32 [T, Np]
    (crash_at_round / crash_recover), held against round ``r``.
    ``telemetry``: an int32 [Np / 512, TELEM_WIDTH] accumulator the stage
    counters are added into; ``n_local`` is the count of real (unpadded)
    lanes."""
    cols, hon, p0, p1 = _proposal_pass(
        seed, r, phase, hist, pack, m, fault_model, freeze, n_equiv,
        counts_mode, camp_b0, camp_b1, crash_round, recover_round, rejoin)
    if witness_ids:
        cols = torch.cat([cols, _witness_cols(witness_ids, n_local,
                                              [p0, p1])], dim=1)
    if telemetry is not None:
        telemetry += _telem_block(hon.shape, n_local, TILE_N,
                                  counts_mode == "sampled", 1, hon=hon)
    return cols


def _vote_pass(seed, r, phase, hist, pack, quorum_ok, m, n_faulty, rule,
               fault_model, freeze, n_equiv, counts_mode, camp_b0, camp_b1,
               coin_mode, eps, shared, crash_round, recover_round, rejoin,
               record):
    """The vote pass + commit on every lane -> (new plane stack, int32
    [T, VOTE_COLS] base columns, under ``record`` the recorder's after
    them, the lanes' fields for the witness and the telemetry)."""
    x, decided, killed, faulty, k, alive, frozen, down = _load_fields(
        pack, freeze, r, crash_round, recover_round, fault_model, rejoin)
    shape, device = x.shape, pack.device
    v0, v1 = _tallies(seed, r, phase, kernel_vecs(hist, counts_mode), shape,
                      device, m, counts_mode,
                      n_equiv if _has_eq(fault_model, counts_mode) else None,
                      camp_b0, camp_b1)
    coin = _coin(seed, r, shape, device, coin_mode, eps, shared)

    ff = float(n_faulty)
    decide0 = v0 > ff
    decide1 = v1 > ff
    if rule == "reference":
        any_votes = (v0 + v1) > 0.0
        adopt0 = any_votes & (v0 > v1)
        adopt1 = any_votes & (v0 < v1)
        x2 = torch.where(decide0, VAL0,
             torch.where(decide1, VAL1,
             torch.where(adopt0, VAL0,
             torch.where(adopt1, VAL1, coin))))
        no_adopt = ~adopt0 & ~adopt1
    else:
        x2 = torch.where(decide0, VAL0, torch.where(decide1, VAL1, coin))
        no_adopt = torch.ones_like(decide0)
    qok = quorum_ok.to(torch.bool)[:, None]
    active = alive & qok & ~frozen
    new_x = torch.where(active, x2, x)
    new_dec = torch.where(active & (decide0 | decide1), 1, decided)
    new_k = torch.where(active, r + 1, k)
    coined = (active & ~decide0 & ~decide1 & no_adopt).to(torch.int64)
    new_pack = _pack_planes(pack.shape[1] - PACK_STATIC_WIDTH, new_x,
                            new_dec, killed, faulty, new_k, coined, down)

    settled = (new_dec == 1) | (killed == 1)
    hon = _honest(fault_model, alive, faulty)

    def total(mask):
        return mask.sum(1, dtype=torch.int32)[:, None]

    cols = [tally.class_histogram(_sent(fault_model, new_x, faulty), hon),
            total(settled), total(~settled)]
    if record:
        undec = (new_dec == 0) & (killed == 0)
        margin = torch.where(active, (v0 - v1).abs(), 0.0)
        cols += [total(new_dec == 1), total(killed == 1),
                 total(undec & (new_x == VAL0)),
                 total(undec & (new_x == VAL1)),
                 total(undec & (new_x == VALQ)), total(coined == 1),
                 margin.amax(1).to(torch.int32)[:, None]]
    cols = torch.cat(cols, dim=1)
    lanes = dict(fields=[new_x, new_dec, killed, coined, v0, v1], hon=hon,
                 active=active, coined=coined == 1)
    return new_pack, cols, lanes


def vote_commit_plain(seed, r, phase, hist, pack, quorum_ok, m, n_faulty,
                      rule, fault_model, freeze, n_equiv=None,
                      counts_mode="sampled", camp_b0=0, camp_b1=0,
                      coin_mode="private", eps=0.0, shared=None,
                      crash_round=None, recover_round=None,
                      rejoin="durable", record=False, witness_ids=(),
                      n_local=0, telemetry=None):
    """Plain version of the vote kernel -> (new plane stack, int32
    [T, VOTE_COLS]: next round's proposal histogram over honest live lanes,
    settled, unsettled; under ``record`` the VOTE_RECORD_LAYOUT columns
    after them, then for each of ``witness_ids`` its lane's
    WITNESS_VOTE_FIELDS).  ``shared``: the trial's shared coin bit [T]
    (common and weak_common coins).  The new stack keeps the latched killed
    lanes and, under crash_recover, this round's down lanes; a down lane is
    unsettled.  ``telemetry``: the accumulator the stage counters are added
    into, as in ``proposal_hist_plain``."""
    new_pack, cols, lanes = _vote_pass(
        seed, r, phase, hist, pack, quorum_ok, m, n_faulty, rule,
        fault_model, freeze, n_equiv, counts_mode, camp_b0, camp_b1,
        coin_mode, eps, shared, crash_round, recover_round, rejoin, record)
    if witness_ids:
        cols = torch.cat([cols, _witness_cols(witness_ids, n_local,
                                              lanes["fields"])], dim=1)
    if telemetry is not None:
        telemetry += _telem_block(
            lanes["hon"].shape, n_local, TILE_N, counts_mode == "sampled",
            2, lanes["hon"], lanes["active"], lanes["coined"])
    return new_pack, cols


def fused_round_plain(seed, r, hist1, pack, m, n_faulty, rule, fault_model,
                      freeze, n_equiv=None, coin_mode="private", eps=0.0,
                      shared=None, crash_round=None, recover_round=None,
                      rejoin="durable", record=False, witness_ids=(),
                      n_local=0, telemetry=None):
    """Plain version of the single-pass kernel (sampled counts): the
    proposal pass, the whole-axis vote histogram and quorum gate, then the
    vote pass -> (new plane stack, partsA [T, PROP_COLS], partsB
    [T, VOTE_COLS]), each with the observability columns of
    ``proposal_hist_plain`` / ``vote_commit_plain``; ``telemetry``: an
    int32 [2, 1, TELEM_WIDTH] accumulator the two stages' counters over one
    tile (the whole padded node axis) are added into."""
    bounds = (crash_round, recover_round, rejoin)
    parts_a, hon, p0, p1 = _proposal_pass(
        seed, r, rng.PHASE_PROPOSAL, hist1, pack, m, fault_model, freeze,
        n_equiv, "sampled", 0, 0, *bounds)
    new_pack, parts_b, lanes = _vote_pass(
        seed, r, rng.PHASE_VOTE, parts_a[:, :3], pack, parts_a[:, 3] >= m,
        m, n_faulty, rule, fault_model, freeze, n_equiv, "sampled", 0, 0,
        coin_mode, eps, shared, *bounds, record)
    if witness_ids:
        parts_a = torch.cat([parts_a, _witness_cols(witness_ids, n_local,
                                                    [p0, p1])], dim=1)
        parts_b = torch.cat([parts_b, _witness_cols(
            witness_ids, n_local, lanes["fields"])], dim=1)
    if telemetry is not None:
        shape = hon.shape
        telemetry[0] += _telem_block(shape, n_local, shape[1], True, 1,
                                     hon=hon)
        telemetry[1] += _telem_block(shape, n_local, shape[1], True, 1,
                                     lanes["hon"], lanes["active"],
                                     lanes["coined"])
    return new_pack, parts_a, parts_b


# --------------------------------------------------------------------------
# Kernel wrappers: device dispatch, checks, launch, launch counters.
# --------------------------------------------------------------------------


def _check_pack(pack):
    if pack.dim() != 3 or pack.shape[1] <= PACK_STATIC_WIDTH:
        raise ValueError(f"pack: expected [T, planes > {PACK_STATIC_WIDTH}, "
                         f"words], got {tuple(pack.shape)}")
    check("pack", pack, torch.int32, pack.shape, pack.device)


def _check_modes(fault_model, rule="reference", counts_mode="sampled",
                 coin_mode="private", eps=0.0, n_equiv=None, shared=None,
                 crash_round=None, recover_round=None, rejoin="durable"):
    if fault_model not in _FAULT_MODELS:
        raise ValueError(f"unknown fault_model: {fault_model}")
    if rejoin not in REJOIN_MODES:
        raise ValueError(f"unknown rejoin mode: {rejoin}")
    if fault_model in FAULT_ROUNDS and crash_round is None:
        raise ValueError(f"fault_model={fault_model!r} needs crash_round")
    if fault_model == "crash_recover" and recover_round is None:
        raise ValueError("fault_model='crash_recover' needs recover_round")
    if rule not in ("reference", "textbook"):
        raise ValueError(f"unknown rule: {rule}")
    if counts_mode not in COUNTS_MODES:
        raise ValueError(f"unknown counts_mode: {counts_mode}")
    if coin_mode not in COIN_MODES:
        raise ValueError(f"unknown coin_mode: {coin_mode}")
    if coin_mode == "weak_common" and not 0.0 < eps < 1.0:
        raise ValueError(f"weak_common coin needs 0 < eps < 1, got {eps}")
    if coin_mode != "private" and shared is None:
        raise ValueError(f"coin_mode={coin_mode!r} needs the shared bit")
    if _has_eq(fault_model, counts_mode) and n_equiv is None:
        raise ValueError("equivocate under sampled counts needs n_equiv")


def _mode_ids(counts_mode, coin_mode, fault_model):
    """The kernels' (counts, coin, equiv, honest) mode ids: honest, the
    vote histograms leave the equivocators out."""
    return (COUNTS_MODES.index(counts_mode), COIN_MODES.index(coin_mode),
            int(_has_eq(fault_model, counts_mode)),
            int(fault_model == "equivocate"))


def _fault_ids(fault_model):
    """The kernels' runtime fault flags (byz, honest)."""
    return int(fault_model == "byzantine"), int(fault_model == "equivocate")


def _bounds_operands(fault_model, crash_round, recover_round, rejoin, pack):
    """The round bounds a launch reads, checked: (crash_round int32 [T, Np]
    or None, recover_round or None, amnesia flag)."""
    t, _, n_w = pack.shape
    out = []
    for name, a, model in (("crash_round", crash_round, FAULT_ROUNDS),
                           ("recover_round", recover_round,
                            ("crash_recover",))):
        if fault_model not in model:
            out.append(None)
            continue
        check(name, a, torch.int32, (t, n_w * PACK_NODES_PER_WORD),
              pack.device)
        out.append(a)
    return (*out, int(fault_model == "crash_recover"
                      and rejoin == "amnesia"))


def _opt_ptr(t):
    """A kernel operand that the launch's modes may not read (None: a null
    pointer)."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


@functools.cache
def round_blocks(lib, kernel: int, n_w: int, t: int, device,
                 modes=(0, 0, 0, 0), fault=0, obs=False) -> int:
    """Blocks a trial of proposal_hist (``kernel`` 0) or vote_commit (1),
    or with ``obs`` of its armed twin, in ``modes`` (``_mode_ids``) and
    FaultRounds mode ``fault`` on ``device`` for ``n_w`` plane words and
    ``t`` trials: one wave of the kernel over the card, worked out once per
    shape and modes.  It sizes the partials and is passed to the launch.  A
    failed CUDA query raises."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        raise_on(lib.benor_round_blocks(kernel, *modes, fault, int(obs), n_w,
                                        t, ctypes.byref(blocks)),
                 "round_blocks")
    return blocks.value


class Obs(ctypes.Structure):
    """An armed launch's operands (csrc/round_body.cuh ``Obs``): the witness
    outputs int32 [T, k, 2] (proposal) and [T, k, 6] (vote), the stage
    counters, the watched ids [0, lo) and [hs, hs + k - lo), and the real
    lanes ``n_local``; a null pointer leaves its plane off."""
    _fields_ = [("wit_a", ctypes.c_void_p), ("wit_b", ctypes.c_void_p),
                ("telem", ctypes.c_void_p), ("lo", ctypes.c_int),
                ("hs", ctypes.c_int), ("k", ctypes.c_int),
                ("n_local", ctypes.c_int)]


def watched_ranges(witness_ids) -> tuple[int, int, int]:
    """``witness_ids`` as the kernels take them -> (lo, hs, k): the ids must
    be 0 .. lo - 1 then hs .. hs + k - lo - 1, as state.witness_node_ids
    gives them; any other set raises."""
    ids = [int(i) for i in witness_ids]
    lo = 0
    while lo < len(ids) and ids[lo] == lo:
        lo += 1
    rest = ids[lo:]
    hs = rest[0] if rest else 0
    if rest != list(range(hs, hs + len(rest))):
        raise ValueError(f"witness_ids: the kernels watch a low and a high "
                         f"range of node ids, got {ids}")
    return lo, hs, len(ids)


def _telem_shape_cols(telem, t, n_local, tile, sampled, hops):
    """Fill a stage's counters that depend on the shape and mode alone
    (real and pad lanes, sampler draws, plane passes) into its
    [tiles, TELEM_WIDTH] block; the kernel adds the others."""
    tiles = telem.shape[0]
    start = torch.arange(tiles, dtype=torch.int32)
    real = (n_local - start * tile).clamp(0, tile) * t
    telem[:, TELEM_COLS["active_lanes"][0]] = real
    telem[:, TELEM_COLS["pad_lanes"][0]] = t * tile - real
    telem[:, TELEM_COLS["sampler_draws"][0]] = t * tile if sampled else 0
    telem[:, TELEM_COLS["plane_hops"][0]] = t * hops
    return telem


@functools.cache
def _telem_shape(device, t, tiles, tile, n_local, sampled, hops):
    """The shape columns of a launch's counter blocks, int32 [stages,
    tiles, TELEM_WIDTH] on ``device`` (``hops``: each stage's plane
    passes), the other columns 0."""
    tel = torch.zeros((len(hops), tiles, TELEM_WIDTH), dtype=torch.int32)
    for i, h in enumerate(hops):
        _telem_shape_cols(tel[i], t, n_local, tile, sampled, h)
    return tel.to(device)


def _add_shape_cols(telemetry, t, n_local, tile, sampled, hops):
    """Add a launch's shape columns into its ``telemetry`` accumulator
    (``_telem_shape``), beside the counts its kernel adds."""
    telemetry += _telem_shape(telemetry.device, t, telemetry.shape[-2],
                              tile, int(n_local), bool(sampled),
                              tuple(hops)).view(telemetry.shape)


def _obs_operands(t, device, witness_ids, n_local, telemetry=None):
    """The witness outputs of an armed launch and its ``Obs`` -> (obs,
    wit_a, wit_b): the witness outputs int32 [T, k, 2] and [T, k, 6]
    zeroed where ``witness_ids`` are given (else None), one buffer; the
    kernel adds its counters into ``telemetry`` where given."""
    lo, hs, k = watched_ranges(witness_ids)
    buf = torch.zeros(t * k * (_WITA_PER_NODE + _WITB_PER_NODE),
                      dtype=torch.int32, device=device)
    n_a = t * k * _WITA_PER_NODE
    wit_a = buf[:n_a].view(t, k, _WITA_PER_NODE) if k else None
    wit_b = buf[n_a:].view(t, k, _WITB_PER_NODE) if k else None
    obs = Obs(*(None if a is None else a.data_ptr()
                for a in (wit_a, wit_b, telemetry)), lo, hs, k, int(n_local))
    return obs, wit_a, wit_b


def _check_telem(telemetry, shape, device):
    """A ``telemetry`` accumulator must be what the kernel adds into."""
    if telemetry is not None:
        check("telemetry", telemetry, torch.int32, shape, device)


def _sum_vote_parts(parts, record):
    """Per-block vote partials [blocks, T, cols] -> [T, cols'] summed over
    blocks; an armed launch's margin column takes the max, and its recorder
    columns are kept under ``record`` only."""
    out = parts.sum(0, dtype=torch.int32)
    if parts.shape[2] == VOTE_OBS_COLS:
        out[:, _RP["tally_margin"]] = parts[:, :, _RP["tally_margin"]].amax(0)
    return out[:, :_witb_base(record)]


def _launch_proposal_hist(lib, key, hist_f, pack, m, fault_model, freeze,
                          counts_mode="sampled", key2=(0, 0), ne_f=None,
                          camps=(0, 0), r=0, bounds=(None, None, 0),
                          obs=None):
    """One launch of the proposal kernel -> raw per-block partials int32
    [blocks, T, PROP_COLS].  ``hist_f``: the count operand
    (``kernel_vecs``); ``key2``, ``ne_f``: the equivocate draws' second
    stream key and live equivocators f32 [T]; ``camps``: the camp bounds;
    ``bounds``: (crash_round, recover_round, amnesia) of
    ``_bounds_operands``, held against round ``r``; ``obs``: an ``Obs``
    launches the armed twin."""
    t, p, n_w = pack.shape
    modes = _mode_ids(counts_mode, "private", fault_model)
    fault = FAULT_ROUNDS.get(fault_model, 0)
    blocks = round_blocks(lib, 0, n_w, t, pack.device, modes, fault,
                          obs is not None)
    parts = torch.empty((blocks, t, PROP_COLS), dtype=torch.int32,
                        device=pack.device)
    raise_on(lib.benor_proposal_hist(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), ptr(parts), t, p, n_w,
        key[0], key[1], key2[0], key2[1], camps[0], camps[1], float(m),
        modes[0], modes[2], *_fault_ids(fault_model), int(bool(freeze)),
        _opt_ptr(bounds[0]), _opt_ptr(bounds[1]), int(r), fault, bounds[2],
        blocks, stream(pack.device),
        None if obs is None else ctypes.byref(obs)), "proposal_hist")
    return parts


def _launch_vote_commit(lib, vkey, ckey, rk, hist_f, qok, pack, m, n_faulty,
                        rule, fault_model, freeze, counts_mode="sampled",
                        coin_mode="private", vkey2=(0, 0), ne_f=None,
                        shared_i=None, eps=0.0, camps=(0, 0),
                        bounds=(None, None, 0), obs=None):
    """One launch of the vote kernel -> (new plane stack, raw per-block
    partials int32 [blocks, T, VOTE_COLS]; VOTE_OBS_COLS for the armed
    twin, which an ``obs`` launches).  ``shared_i``: the trial's shared
    coin bit, int32 [T]; ``bounds`` held against round rk - 1."""
    t, p, n_w = pack.shape
    modes = _mode_ids(counts_mode, coin_mode, fault_model)
    fault = FAULT_ROUNDS.get(fault_model, 0)
    blocks = round_blocks(lib, 1, n_w, t, pack.device, modes, fault,
                          obs is not None)
    new_pack = torch.empty_like(pack)
    parts = torch.empty((blocks, t, VOTE_COLS if obs is None
                         else VOTE_OBS_COLS), dtype=torch.int32,
                        device=pack.device)
    raise_on(lib.benor_vote_commit(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), ptr(qok), _opt_ptr(shared_i),
        ptr(new_pack), ptr(parts), t, p, n_w, vkey[0], vkey[1], vkey2[0],
        vkey2[1], ckey[0], ckey[1], camps[0], camps[1], int(rk), float(m),
        float(n_faulty), float(eps), *modes[:3], int(rule == "textbook"),
        *_fault_ids(fault_model), int(bool(freeze)), _opt_ptr(bounds[0]),
        _opt_ptr(bounds[1]), fault, bounds[2], blocks, stream(pack.device),
        None if obs is None else ctypes.byref(obs)), "vote_commit")
    return new_pack, parts


def fused_cluster(n_w: int, trials: int, fits) -> tuple[int, int]:
    """The fused kernel's grid rule: ``n_w`` plane words and ``trials``
    trials -> (C blocks a trial's cluster, W warps a block).
    ``fits[(C, W)]``: the clusters of C blocks of W warps the card holds at
    once (``fused_fits``).  Warp g of a trial takes words g, g + C * W, ...;
    among the (C, W) that give every warp a word and none more than
    FUSED_KEEP, the first by: all ``trials`` clusters at once (one wave),
    the most warps a trial (the shortest chain of words a warp), C = 1 (a
    plain launch, without the cluster's launch and barrier costs), the most
    blocks a cluster (an SM then holds blocks of several trials, whose
    per-trial terms and barriers overlap the others' words)."""
    best = None
    for w in FUSED_WARPS:
        for c in FUSED_CLUSTERS:
            if not c * w <= n_w <= c * w * FUSED_KEEP:
                continue
            key = (trials <= fits[(c, w)], c * w, c == 1, c)
            if best is None or key > best[0]:
                best = (key, (c, w))
    if best is None:
        raise ValueError(f"fused_round: no grid for {n_w} words")
    return best[1]


@functools.cache
def fused_fits(lib, device, coin_mode="private", equiv=False, fault=0,
               obs=False) -> dict:
    """{(C, W): clusters of C blocks of W warps of the fused kernel in
    ``coin_mode`` (``equiv``: with the equivocate draws; ``fault``: the
    FaultRounds mode; ``obs``: its armed twin) that ``device`` holds at
    once} for every choice
    (``benor_fused_fits``, which also allows the kernel the non-portable
    C = 16 there), asked once per device and modes.  A failed CUDA query
    raises."""
    out = {}
    with torch.cuda.device(device):
        for c in FUSED_CLUSTERS:
            for w in FUSED_WARPS:
                n = ctypes.c_int(0)
                raise_on(lib.benor_fused_fits(
                    c, w, COIN_MODES.index(coin_mode), int(equiv), fault,
                    int(obs), ctypes.byref(n)), "fused_fits")
                out[(c, w)] = n.value
    return out


@functools.cache
def fused_grid(lib, n_w: int, t: int, device, coin_mode="private",
               equiv=False, fault=0, obs=False) -> tuple[int, int]:
    """The fused kernel's (C, W) on ``device`` for ``n_w`` words and ``t``
    trials in ``coin_mode`` / ``equiv`` / ``fault`` (``obs``: its armed
    twin): ``fused_cluster`` on the device's ``fused_fits``, worked out
    once per shape and modes."""
    return fused_cluster(n_w, t, fused_fits(lib, device, coin_mode, equiv,
                                            fault, obs))


def _launch_fused_round(lib, pkey, vkey, ckey, rk, hist_f, pack, m, n_faulty,
                        rule, fault_model, freeze, grid, coin_mode="private",
                        pkey2=(0, 0), vkey2=(0, 0), ne_f=None, shared_i=None,
                        eps=0.0, bounds=(None, None, 0), obs=None):
    """One launch of the single-pass kernel as ``t`` clusters of C blocks
    of W warps, ``grid`` = (C, W) (``fused_grid``'s, or one a measurement
    names) -> (new plane stack, partsA int32 [T, PROP_COLS], partsB int32
    [T, VOTE_COLS]; VOTE_OBS_COLS for the armed twin, which an ``obs``
    launches); ``bounds`` held against round rk - 1."""
    t, p, n_w = pack.shape
    if n_w * PACK_NODES_PER_WORD > FUSED_ONE_PASS_MAX_NODES:
        raise ValueError(f"fused_round: {n_w} words exceed the one-pass cap")
    new_pack = torch.empty_like(pack)
    parts_a = torch.empty((t, PROP_COLS), dtype=torch.int32,
                          device=pack.device)
    parts_b = torch.empty((t, VOTE_COLS if obs is None else VOTE_OBS_COLS),
                          dtype=torch.int32, device=pack.device)
    _, coin, equiv, _ = _mode_ids("sampled", coin_mode, fault_model)
    raise_on(lib.benor_fused_round(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), _opt_ptr(shared_i),
        ptr(new_pack), ptr(parts_a), ptr(parts_b), t, p, n_w, pkey[0],
        pkey[1], pkey2[0], pkey2[1], vkey[0], vkey[1], vkey2[0], vkey2[1],
        ckey[0], ckey[1], int(rk), float(m), float(n_faulty), float(eps),
        coin, equiv, int(rule == "textbook"), *_fault_ids(fault_model),
        int(bool(freeze)), _opt_ptr(bounds[0]), _opt_ptr(bounds[1]),
        FAULT_ROUNDS.get(fault_model, 0), bounds[2], grid[0], grid[1],
        stream(pack.device), None if obs is None else ctypes.byref(obs)),
        "fused_round")
    return new_pack, parts_a, parts_b


def _shared_i(shared, t, device):
    """The shared coin bit as the kernels' int32 [T] operand (None when no
    coin reads it)."""
    if shared is None:
        return None
    out = shared.to(torch.int32).contiguous()
    check("shared", out, torch.int32, (t,), device)
    return out


def _equiv_operands(seed, r, phase, n_equiv, fault_model, counts_mode, t,
                    device):
    """(second stream key, live equivocators f32 [T]) of the equivocate
    draws, or ((0, 0), None) where the kernel makes none."""
    if not _has_eq(fault_model, counts_mode):
        return (0, 0), None
    ne_f = count_vecs(n_equiv)
    check("n_equiv", ne_f, torch.float32, (t,), device)
    return stream_scal(seed, r, phase + _EQUIV_SALT_OFFSET), ne_f


def proposal_hist(seed, r, phase, hist, pack, m, fault_model, freeze,
                  n_equiv=None, counts_mode="sampled", camp_b0=0, camp_b1=0,
                  crash_round=None, recover_round=None, rejoin="durable",
                  witness_ids=(), n_local=0, telemetry=None):
    """The proposal pass -> int32 [T, PROP_COLS] summed over the node axis
    (cols 0-2 vote histogram over honest live lanes, col 3 alive count).
    ``hist``: the phase's counts in ``counts_mode``'s layout; ``n_equiv``:
    live equivocators int32 [T] (equivocate under sampled counts);
    ``camp_b0`` / ``camp_b1``: the targeted adversary's camp bounds;
    ``crash_round`` / ``recover_round``: the round bounds int32 [T, Np]
    (``pad_fault_rounds``; crash_at_round / crash_recover) and ``rejoin``
    the rejoin mode (crash_recover).  ``witness_ids`` (watched global node
    ids, ``watched_ranges``' form) append each one's p0 and p1;
    ``telemetry``, an int32 [Np / 512, TELEM_WIDTH] accumulator, gets the
    stage counters added; either launches the armed twin.  ``n_local``: the
    real (unpadded) lanes."""
    bounds = dict(crash_round=crash_round, recover_round=recover_round,
                  rejoin=rejoin)
    _check_modes(fault_model, counts_mode=counts_mode, n_equiv=n_equiv,
                 **bounds)
    obs_kw = dict(witness_ids=witness_ids, n_local=n_local,
                  telemetry=telemetry)
    if on_cpu(pack.device, "round kernels"):
        return proposal_hist_plain(seed, r, phase, hist, pack, m,
                                   fault_model, freeze, n_equiv, counts_mode,
                                   camp_b0, camp_b1, **bounds, **obs_kw)
    from ._build import load_library

    _check_pack(pack)
    t, _, n_w = pack.shape
    hist_f = kernel_vecs(hist, counts_mode)
    check("hist", hist_f, torch.float32, (t, hist_f.shape[1]), pack.device)
    key2, ne_f = _equiv_operands(seed, r, phase, n_equiv, fault_model,
                                 counts_mode, t, pack.device)
    obs = wit_a = None
    if witness_ids or telemetry is not None:
        _check_telem(telemetry, (n_w * PACK_NODES_PER_WORD // TILE_N,
                                 TELEM_WIDTH), pack.device)
        obs, wit_a, _ = _obs_operands(t, pack.device, witness_ids, n_local,
                                      telemetry)
    parts = _launch_proposal_hist(
        load_library(), stream_scal(seed, r, phase), hist_f, pack, m,
        fault_model, freeze, counts_mode, key2, ne_f, (camp_b0, camp_b1), r,
        _bounds_operands(fault_model, crash_round, recover_round, rejoin,
                         pack), obs)
    if obs is None:
        proposal_hist.launches += 1
    else:
        proposal_hist.obs_launches += 1
    if telemetry is not None:
        _add_shape_cols(telemetry, t, n_local, TILE_N,
                        counts_mode == "sampled", (1,))
    out = parts.sum(0, dtype=torch.int32)
    if wit_a is not None:
        out = torch.cat([out, wit_a.reshape(t, -1)], dim=1)
    return out


def vote_commit(seed, r, phase, hist, pack, quorum_ok, m, n_faulty, rule,
                fault_model, freeze, n_equiv=None, counts_mode="sampled",
                camp_b0=0, camp_b1=0, coin_mode="private", eps=0.0,
                shared=None, crash_round=None, recover_round=None,
                rejoin="durable", record=False, witness_ids=(), n_local=0,
                telemetry=None):
    """The vote pass + commit -> (new plane stack, int32 [T, VOTE_COLS]
    summed over the node axis).  ``shared``: the trial's shared coin bit
    [T] (common and weak_common coins, ``eps`` the weak coin's deviation
    rate); the round bounds as in ``proposal_hist``.  ``record`` appends
    the VOTE_RECORD_LAYOUT columns (the margin a max over the node axis),
    ``witness_ids`` each watched lane's WITNESS_VOTE_FIELDS, and
    ``telemetry`` gets the stage counters added as in ``proposal_hist``;
    any of them launches the armed twin."""
    bounds = dict(crash_round=crash_round, recover_round=recover_round,
                  rejoin=rejoin)
    _check_modes(fault_model, rule, counts_mode, coin_mode, eps, n_equiv,
                 shared, **bounds)
    obs_kw = dict(record=record, witness_ids=witness_ids, n_local=n_local,
                  telemetry=telemetry)
    if on_cpu(pack.device, "round kernels"):
        return vote_commit_plain(seed, r, phase, hist, pack, quorum_ok, m,
                                 n_faulty, rule, fault_model, freeze,
                                 n_equiv, counts_mode, camp_b0, camp_b1,
                                 coin_mode, eps, shared, **bounds, **obs_kw)
    from ._build import load_library

    _check_pack(pack)
    t, _, n_w = pack.shape
    hist_f = kernel_vecs(hist, counts_mode)
    qok = quorum_ok.to(torch.int32).contiguous()
    check("hist", hist_f, torch.float32, (t, hist_f.shape[1]), pack.device)
    check("quorum_ok", qok, torch.int32, (t,), pack.device)
    key2, ne_f = _equiv_operands(seed, r, phase, n_equiv, fault_model,
                                 counts_mode, t, pack.device)
    obs = wit_b = None
    if record or witness_ids or telemetry is not None:
        _check_telem(telemetry, (n_w * PACK_NODES_PER_WORD // TILE_N,
                                 TELEM_WIDTH), pack.device)
        obs, _, wit_b = _obs_operands(t, pack.device, witness_ids, n_local,
                                      telemetry)
    new_pack, parts = _launch_vote_commit(
        load_library(), stream_scal(seed, r, phase),
        stream_scal(seed, r, _COIN_SALT), r + 1, hist_f, qok, pack, m,
        n_faulty, rule, fault_model, freeze, counts_mode, coin_mode, key2,
        ne_f, _shared_i(None if coin_mode == "private" else shared, t,
                        pack.device), eps, (camp_b0, camp_b1),
        _bounds_operands(fault_model, crash_round, recover_round, rejoin,
                         pack), obs)
    if obs is None:
        vote_commit.launches += 1
    else:
        vote_commit.obs_launches += 1
    if telemetry is not None:
        _add_shape_cols(telemetry, t, n_local, TILE_N,
                        counts_mode == "sampled", (2,))
    out = _sum_vote_parts(parts, record)
    if wit_b is not None:
        out = torch.cat([out, wit_b.reshape(t, -1)], dim=1)
    return new_pack, out


def fused_round(seed, r, hist1, pack, m, n_faulty, rule, fault_model,
                freeze, n_equiv=None, coin_mode="private", eps=0.0,
                shared=None, crash_round=None, recover_round=None,
                rejoin="durable", record=False, witness_ids=(), n_local=0,
                telemetry=None):
    """A whole round in one kernel (sampled counts) -> (new plane stack,
    partsA [T, PROP_COLS], partsB [T, VOTE_COLS]); the round bounds as in
    ``proposal_hist``, the observability planes as in ``proposal_hist``
    (partsA) and ``vote_commit`` (partsB); ``telemetry``, an int32
    [2, 1, TELEM_WIDTH] accumulator, gets the two stages' counters over
    one tile added."""
    bounds = dict(crash_round=crash_round, recover_round=recover_round,
                  rejoin=rejoin)
    _check_modes(fault_model, rule, "sampled", coin_mode, eps, n_equiv,
                 shared, **bounds)
    obs_kw = dict(record=record, witness_ids=witness_ids, n_local=n_local,
                  telemetry=telemetry)
    if on_cpu(pack.device, "round kernels"):
        return fused_round_plain(seed, r, hist1, pack, m, n_faulty, rule,
                                 fault_model, freeze, n_equiv, coin_mode,
                                 eps, shared, **bounds, **obs_kw)
    from ._build import load_library

    _check_pack(pack)
    t, _, n_w = pack.shape
    hist_f = count_vecs(hist1)
    check("hist1", hist_f, torch.float32, (t, 3), pack.device)
    pkey2, ne_f = _equiv_operands(seed, r, rng.PHASE_PROPOSAL, n_equiv,
                                  fault_model, "sampled", t, pack.device)
    vkey2, _ = _equiv_operands(seed, r, rng.PHASE_VOTE, n_equiv,
                               fault_model, "sampled", t, pack.device)
    obs = wit_a = wit_b = None
    if record or witness_ids or telemetry is not None:
        _check_telem(telemetry, (2, 1, TELEM_WIDTH), pack.device)
        obs, wit_a, wit_b = _obs_operands(t, pack.device, witness_ids,
                                          n_local, telemetry)
    lib = load_library()
    grid = fused_grid(lib, n_w, t, pack.device, coin_mode, ne_f is not None,
                      FAULT_ROUNDS.get(fault_model, 0), obs is not None)
    new_pack, parts_a, parts_b = _launch_fused_round(
        lib, stream_scal(seed, r, rng.PHASE_PROPOSAL),
        stream_scal(seed, r, rng.PHASE_VOTE),
        stream_scal(seed, r, _COIN_SALT), r + 1, hist_f, pack, m, n_faulty,
        rule, fault_model, freeze, grid, coin_mode, pkey2, vkey2, ne_f,
        _shared_i(None if coin_mode == "private" else shared, t,
                  pack.device), eps,
        _bounds_operands(fault_model, crash_round, recover_round, rejoin,
                         pack), obs)
    if obs is None:
        fused_round.launches += 1
    else:
        fused_round.obs_launches += 1
    if telemetry is not None:
        _add_shape_cols(telemetry, t, n_local, n_w * PACK_NODES_PER_WORD,
                        True, (1, 1))
    parts_b = parts_b[:, :_witb_base(record)]
    if wit_a is not None:
        parts_a = torch.cat([parts_a, wit_a.reshape(t, -1)], dim=1)
        parts_b = torch.cat([parts_b, wit_b.reshape(t, -1)], dim=1)
    return new_pack, parts_a, parts_b


proposal_hist.launches = 0
vote_commit.launches = 0
fused_round.launches = 0
proposal_hist.obs_launches = 0
vote_commit.obs_launches = 0
fused_round.obs_launches = 0

#: The kernel wrappers, by name (their launch counters are ``.launches``).
KERNELS = {"proposal_hist": proposal_hist, "vote_commit": vote_commit,
           "fused_round": fused_round}
#: The armed twins, by name: the same wrappers, counted in
#: ``.obs_launches``.
OBS_KERNELS = {"proposal_hist_obs": proposal_hist,
               "vote_commit_obs": vote_commit,
               "fused_round_obs": fused_round}


def obs_launch_counts() -> dict:
    """The armed twins' launches by name."""
    return {k: fn.obs_launches for k, fn in OBS_KERNELS.items()}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
        fn.obs_launches = 0


# --------------------------------------------------------------------------
# The round and the loop.
# --------------------------------------------------------------------------


def shared_coin(cfg, seed, r, t, device):
    """This round's shared coin bit a trial, int [T]: one draw of the
    ``fold_in`` chain keyed on the trial ids (the common coin's stream), or
    None under the private coin."""
    if cfg.coin_mode == "private":
        return None
    return rng.coin_flips(seed, r, rng.ids(t, device=device),
                          rng.ids(1, device=device), common=True)[:, 0]


def packed_round(cfg, pack, seed, r, hist1, n_local, n_equiv=None,
                 bounds=(None, None), telemetry=None):
    """One round over the plane stack -> (new_pack, next round's proposal
    histogram int32 [T, 3], unsettled int32 [T], row, wrow); the round's
    stage counters are added into ``telemetry``, an int32 [2, tiles,
    TELEM_WIDTH] accumulator (TELEM_STAGES order, ``telemetry_tiles``),
    where given.
    The single-pass kernel within the caps (sampled counts), else the
    two-kernel path with the node-axis sum (and the quorum gate
    n_alive >= m) between the passes.  Under the count-controlling
    adversaries the kernels get each phase's closed-form counts
    (``tally.adversarial_counts``: 'delivered';
    ``tally.targeted_camp_triples`` and the camp bounds: 'camps'), the
    live equivocators ``n_equiv`` their free pool.  ``bounds``: the round
    bounds (``pad_fault_rounds``); under their models the returned
    histogram is not next round's, which the caller recomputes
    (``sent_hist_from_pack``).  ``row`` is the flight recorder's row int32
    [state.REC_WIDTH] under cfg.record (the pad lanes taken off killed, the
    margin each trial's max summed over trials), ``wrow`` the witness row
    int32 [W, k, state.WIT_WIDTH] under cfg.witness; else None."""
    from ..state import REC_COLUMNS, REC_KILLED, witness_node_ids

    t = pack.shape[0]
    np_total = pack.shape[2] * PACK_NODES_PER_WORD
    m = cfg.quorum
    mode = tally.pallas_round_counts_mode(cfg)
    camp_b0, camp_b1 = (tally.targeted_camp_bounds(cfg) if mode == "camps"
                        else (0, 0))

    def kernel_counts(hist):
        if mode == "delivered":
            return tally.adversarial_counts(hist, m, n_free=n_equiv)
        if mode == "camps":
            return tally.targeted_camp_triples(cfg, hist, n_free=n_equiv)
        return hist

    wids = (tuple(int(i) for i in witness_node_ids(cfg)) if cfg.witness
            else ())
    obs = dict(witness_ids=wids, n_local=n_local)
    modes = dict(fault_model=cfg.fault_model,
                 freeze=bool(cfg.freeze_decided), n_equiv=n_equiv,
                 crash_round=bounds[0], recover_round=bounds[1],
                 rejoin=rejoin_mode(cfg.recovery))
    coin = dict(coin_mode=cfg.coin_mode, eps=float(cfg.coin_eps),
                shared=shared_coin(cfg, seed, r, t, pack.device))
    if fused_one_pass_eligible(cfg, t, n_local):
        new_pack, parts_a, parts_b = fused_round(
            seed, r, hist1, pack, m, cfg.n_faulty, cfg.rule, **modes, **coin,
            record=bool(cfg.record), telemetry=telemetry, **obs)
    else:
        camps = dict(counts_mode=mode, camp_b0=camp_b0, camp_b1=camp_b1)
        tel = (None, None) if telemetry is None else telemetry
        parts_a = proposal_hist(seed, r, rng.PHASE_PROPOSAL,
                                kernel_counts(hist1), pack, m, **modes,
                                **camps, telemetry=tel[0], **obs)
        quorum_ok = parts_a[:, 3] >= m
        new_pack, parts_b = vote_commit(
            seed, r, rng.PHASE_VOTE, kernel_counts(parts_a[:, :3]), pack,
            quorum_ok, m, cfg.n_faulty, cfg.rule, **modes, **camps, **coin,
            record=bool(cfg.record), telemetry=tel[1], **obs)
    row = wrow = None
    if cfg.record:
        # every column is a sum over trials (the margin's of each trial's
        # max); the pad lanes carry the killed bit: take them off
        row = parts_b[:, _RP[REC_COLUMNS[0]]:
                      _RP[REC_COLUMNS[-1]] + 1].sum(0, dtype=torch.int32)
        row[REC_KILLED] -= t * (np_total - n_local)
    if cfg.witness:
        k = cfg.witness_nodes
        wb0 = _witb_base(bool(cfg.record))
        wt = torch.as_tensor(cfg.witness_trials, dtype=torch.int64,
                             device=pack.device)
        pa = parts_a[wt, _WITA_BASE:_WITA_BASE + _WITA_PER_NODE * k]
        wb = parts_b[wt, wb0:wb0 + _WITB_PER_NODE * k]
        pa = pa.reshape(len(wt), k, _WITA_PER_NODE)
        wb = wb.reshape(len(wt), k, _WITB_PER_NODE)
        # state.WIT_LAYOUT: x, decided, killed, coined (the vote pass's
        # first four fields), p0, p1, v0, v1, the written sentinel
        wrow = torch.cat([wb[..., :4], pa, wb[..., 4:],
                          torch.ones_like(pa[..., :1])], dim=-1)
    return new_pack, parts_b[:, :3], parts_b[:, 4], row, wrow


def run_packed_slice(cfg, state, faults, seed, from_round, until_round,
                     recorder=None, witness=None):
    """The packed round loop from ``from_round``, stopping before
    ``until_round`` -> (next_round, NetState), then the filled recorder
    (cfg.record), witness buffer (cfg.witness) and stage-counter
    accumulator (cfg.kernel_telemetry), in that order.

    The JAX package runs this loop on the device (lax.while_loop); here it
    runs on the host and reads the unsettled count once per round — the
    one synchronisation per round, with the same predicate
    ``(r <= max_rounds) & (unsettled > 0) & (r < until_round)``.  The live
    equivocators are counted once, before the loop (the killed and faulty
    planes never change).  Under 'crash_at_round' / 'crash_recover' the
    round's proposal histogram is recomputed from the plane stack at the
    top of every round (the vote kernel's is not next round's), as the JAX
    package's loop does (pallas_round.py:1619-1621).  ``recorder`` /
    ``witness`` continue the buffers of an earlier slice (copied, then
    written a row a round); None starts fresh ones from ``state``.  The
    accumulator int32 [2, telemetry_tiles, TELEM_WIDTH] is this call's
    rounds only, so a sliced run's add up to the one-shot run's.  Under
    cfg.debug every round emits its event (utils/tracing.py) from the
    unpacked state after it, in order."""
    from ..state import (new_recorder, new_witness, recorder_write,
                         witness_write)
    from ..utils.tracing import emit_round_event

    n_local = state.x.shape[-1]
    if cfg.record:
        recorder = (new_recorder(cfg, state) if recorder is None
                    else recorder.clone())
    if cfg.witness:
        witness = (new_witness(cfg, state) if witness is None
                   else witness.clone())
    pack = pack_state(cfg, state, faults.faulty)
    telem = None
    if cfg.kernel_telemetry:
        telem = torch.zeros((len(TELEM_STAGES),
                             telemetry_tiles(cfg, pack.shape[0], n_local),
                             TELEM_WIDTH), dtype=torch.int32,
                            device=pack.device)
    bounds = pad_fault_rounds(cfg, faults, pack.shape[2] * PACK_NODES_PER_WORD)
    per_round = cfg.fault_model in FAULT_ROUNDS
    n_equiv = n_equiv_from_pack(cfg, pack)
    hist1 = None if per_round else sent_hist_from_pack(cfg, pack)
    unsettled = int(unsettled_from_pack(pack))
    r = int(from_round)
    while r <= cfg.max_rounds and r < until_round and unsettled > 0:
        if per_round:
            hist1 = sent_hist_from_pack(cfg, pack, *bounds, r)
        pack, hist1, unsett, row, wrow = packed_round(
            cfg, pack, seed, r, hist1, n_local, n_equiv, bounds, telem)
        if cfg.record:
            recorder_write(recorder, r, row)
        if cfg.witness:
            witness_write(witness, r, wrow)
        if cfg.debug:
            emit_round_event(unpack_state(pack, n_local))
        unsettled = int(unsett.sum())
        r += 1
    extras = tuple(b for b, on in ((recorder, cfg.record),
                                   (witness, cfg.witness),
                                   (telem, cfg.kernel_telemetry)) if on)
    return (r, unpack_state(pack, n_local), *extras)
