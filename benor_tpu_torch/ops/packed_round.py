"""Fused Ben-Or rounds over BIT-PLANE packed node state
(port of benor_tpu/ops/pallas_round.py: every counts regime, coin and fault
model of its packed round but crash_at_round / crash_recover).

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
the equivocators.

Each wrapper launches its hand-written CUDA kernel (csrc/round_kernels.cu)
on a CUDA tensor and counts the launch in its ``launches`` attribute; on a
CPU tensor it runs its plain torch version, which the tests hold against
the JAX package's Pallas kernels and ``chip_smoke.py`` holds against the
kernel on the card.  Any other device raises.

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
PROP_COLS = max(b + w for b, w in PROP_PARTIAL_LAYOUT.values())
VOTE_COLS = max(b + w for b, w in VOTE_PARTIAL_LAYOUT.values())

_X_BITS = PACK_LAYOUT["x"][1]
_M32 = 0xFFFFFFFF
_FAULT_MODELS = ("crash", "byzantine", "equivocate")
#: The kernels' mode ids (csrc/round_kernels.cu kSampled.., kPrivate..).
COUNTS_MODES = ("sampled", "delivered", "camps")
COIN_MODES = ("private", "common", "weak_common")


def fused_one_pass_eligible(cfg, trials: int, n_nodes: int) -> bool:
    """True iff packed_round takes the single-pass kernel for this
    (config, shape): sampled counts and the padded node axis within the
    caps."""
    if tally.pallas_round_counts_mode(cfg) != "sampled":
        return False
    np_total = n_nodes + (-n_nodes) % TILE_N
    return (np_total <= FUSED_ONE_PASS_MAX_NODES
            and trials * np_total <= FUSED_ONE_PASS_MAX_LANES)


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


def _pack_planes(kbits, x, decided, killed, faulty, k, coined):
    """Per-lane int64 fields [T, Np] -> the plane stack int32
    [T, PACK_STATIC_WIDTH + kbits, Np/32]; the down plane is 0."""
    planes = [None] * (PACK_STATIC_WIDTH + kbits)
    for b in range(_X_BITS):
        planes[PACK_X + b] = (x >> b) & 1
    planes[PACK_DECIDED] = decided
    planes[PACK_KILLED] = killed
    planes[PACK_COINED] = coined
    planes[PACK_FAULTY] = faulty
    planes[PACK_DOWN] = torch.zeros_like(decided)
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


def _load_fields(pack, freeze):
    """Plane stack -> per-lane (x, decided, killed, faulty, k) int64 and
    the (alive, frozen) masks, [T, Np] each."""
    kbits = pack.shape[1] - PACK_STATIC_WIDTH
    x = plane_field(pack, PACK_X, _X_BITS)
    decided = plane_field(pack, PACK_DECIDED, 1)
    killed = plane_field(pack, PACK_KILLED, 1)
    faulty = plane_field(pack, PACK_FAULTY, 1)
    k = plane_field(pack, PACK_K, kbits)
    alive = killed == 0
    frozen = (decided == 1) if freeze else torch.zeros_like(alive)
    return x, decided, killed, faulty, k, alive, frozen


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


def sent_hist_from_pack(cfg, pack: torch.Tensor) -> torch.Tensor:
    """The proposal histogram int32 [T, 3] of the values the honest live
    lanes send (byzantine lanes flipped) — round 1's input to the
    kernels."""
    x = plane_field(pack, PACK_X, _X_BITS)
    killed = plane_field(pack, PACK_KILLED, 1)
    faulty = plane_field(pack, PACK_FAULTY, 1)
    return tally.class_histogram(
        _sent(cfg.fault_model, x, faulty),
        _honest(cfg.fault_model, killed == 0, faulty))


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


def proposal_hist_plain(seed, r, phase, hist, pack, m, fault_model, freeze,
                        n_equiv=None, counts_mode="sampled", camp_b0=0,
                        camp_b1=0):
    """Plain version of the proposal kernel -> int32 [T, PROP_COLS]: the
    vote-class histogram over honest live lanes (cols 0-2) and the alive
    count.  ``hist`` is the phase's counts in ``counts_mode``'s layout
    ([T, 3] histogram or delivered counts, [T, 3, 3] camp triples)."""
    x, decided, killed, faulty, k, alive, frozen = _load_fields(pack, freeze)
    p0, p1 = _tallies(seed, r, phase, kernel_vecs(hist, counts_mode),
                      x.shape, pack.device, m, counts_mode,
                      n_equiv if _has_eq(fault_model, counts_mode) else None,
                      camp_b0, camp_b1)
    x1 = torch.where(p0 > p1, VAL0, torch.where(p1 > p0, VAL1, VALQ))
    vote = _sent(fault_model, torch.where(frozen, x, x1), faulty)
    alive_n = alive.sum(1, dtype=torch.int32)[:, None]
    return torch.cat([
        tally.class_histogram(vote, _honest(fault_model, alive, faulty)),
        alive_n], dim=1)


def vote_commit_plain(seed, r, phase, hist, pack, quorum_ok, m, n_faulty,
                      rule, fault_model, freeze, n_equiv=None,
                      counts_mode="sampled", camp_b0=0, camp_b1=0,
                      coin_mode="private", eps=0.0, shared=None):
    """Plain version of the vote kernel -> (new plane stack, int32
    [T, VOTE_COLS]: next round's proposal histogram over honest live lanes,
    settled, unsettled).  ``shared``: the trial's shared coin bit [T]
    (common and weak_common coins)."""
    x, decided, killed, faulty, k, alive, frozen = _load_fields(pack, freeze)
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
                            new_dec, killed, faulty, new_k, coined)

    settled = (new_dec == 1) | (killed == 1)
    hon = _honest(fault_model, alive, faulty)
    cols = torch.cat([
        tally.class_histogram(_sent(fault_model, new_x, faulty), hon),
        settled.sum(1, dtype=torch.int32)[:, None],
        (~settled).sum(1, dtype=torch.int32)[:, None]], dim=1)
    return new_pack, cols


def fused_round_plain(seed, r, hist1, pack, m, n_faulty, rule, fault_model,
                      freeze, n_equiv=None, coin_mode="private", eps=0.0,
                      shared=None):
    """Plain version of the single-pass kernel (sampled counts): the
    proposal pass, the whole-axis vote histogram and quorum gate, then the
    vote pass -> (new plane stack, partsA [T, PROP_COLS], partsB
    [T, VOTE_COLS])."""
    parts_a = proposal_hist_plain(seed, r, rng.PHASE_PROPOSAL, hist1, pack,
                                  m, fault_model, freeze, n_equiv=n_equiv)
    new_pack, parts_b = vote_commit_plain(
        seed, r, rng.PHASE_VOTE, parts_a[:, :3], pack, parts_a[:, 3] >= m,
        m, n_faulty, rule, fault_model, freeze, n_equiv=n_equiv,
        coin_mode=coin_mode, eps=eps, shared=shared)
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
                 coin_mode="private", eps=0.0, n_equiv=None, shared=None):
    if fault_model not in _FAULT_MODELS:
        raise NotImplementedError(
            f"fault_model={fault_model!r} in the round kernels (ROADMAP "
            "Queue A item 8, Queue B B2)")
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


def _opt_ptr(t):
    """A kernel operand that the launch's modes may not read (None: a null
    pointer)."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


@functools.cache
def round_blocks(lib, kernel: int, n_w: int, t: int, device,
                 modes=(0, 0, 0, 0)) -> int:
    """Blocks a trial of proposal_hist (``kernel`` 0) or vote_commit (1) in
    ``modes`` (``_mode_ids``) on ``device`` for ``n_w`` plane words and
    ``t`` trials: one wave of the kernel over the card, worked out once per
    shape and modes.  It sizes the partials and is passed to the launch.  A
    failed CUDA query raises."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        raise_on(lib.benor_round_blocks(kernel, *modes, n_w, t,
                                        ctypes.byref(blocks)),
                 "round_blocks")
    return blocks.value


def _launch_proposal_hist(lib, key, hist_f, pack, m, fault_model, freeze,
                          counts_mode="sampled", key2=(0, 0), ne_f=None,
                          camps=(0, 0)):
    """One launch of the proposal kernel -> raw per-block partials int32
    [blocks, T, PROP_COLS].  ``hist_f``: the count operand
    (``kernel_vecs``); ``key2``, ``ne_f``: the equivocate draws' second
    stream key and live equivocators f32 [T]; ``camps``: the camp
    bounds."""
    t, p, n_w = pack.shape
    modes = _mode_ids(counts_mode, "private", fault_model)
    blocks = round_blocks(lib, 0, n_w, t, pack.device, modes)
    parts = torch.empty((blocks, t, PROP_COLS), dtype=torch.int32,
                        device=pack.device)
    raise_on(lib.benor_proposal_hist(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), ptr(parts), t, p, n_w,
        key[0], key[1], key2[0], key2[1], camps[0], camps[1], float(m),
        modes[0], modes[2], *_fault_ids(fault_model), int(bool(freeze)),
        blocks, stream(pack.device)), "proposal_hist")
    return parts


def _launch_vote_commit(lib, vkey, ckey, rk, hist_f, qok, pack, m, n_faulty,
                        rule, fault_model, freeze, counts_mode="sampled",
                        coin_mode="private", vkey2=(0, 0), ne_f=None,
                        shared_i=None, eps=0.0, camps=(0, 0)):
    """One launch of the vote kernel -> (new plane stack, raw per-block
    partials int32 [blocks, T, VOTE_COLS]).  ``shared_i``: the trial's
    shared coin bit, int32 [T]."""
    t, p, n_w = pack.shape
    modes = _mode_ids(counts_mode, coin_mode, fault_model)
    blocks = round_blocks(lib, 1, n_w, t, pack.device, modes)
    new_pack = torch.empty_like(pack)
    parts = torch.empty((blocks, t, VOTE_COLS), dtype=torch.int32,
                        device=pack.device)
    raise_on(lib.benor_vote_commit(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), ptr(qok), _opt_ptr(shared_i),
        ptr(new_pack), ptr(parts), t, p, n_w, vkey[0], vkey[1], vkey2[0],
        vkey2[1], ckey[0], ckey[1], camps[0], camps[1], int(rk), float(m),
        float(n_faulty), float(eps), *modes[:3], int(rule == "textbook"),
        *_fault_ids(fault_model), int(bool(freeze)), blocks,
        stream(pack.device)), "vote_commit")
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
def fused_fits(lib, device, coin_mode="private", equiv=False) -> dict:
    """{(C, W): clusters of C blocks of W warps of the fused kernel in
    ``coin_mode`` (``equiv``: with the equivocate draws) that ``device``
    holds at once} for every choice (``benor_fused_fits``, which also allows
    the kernel the non-portable C = 16 there), asked once per device and
    modes.  A failed CUDA query raises."""
    out = {}
    with torch.cuda.device(device):
        for c in FUSED_CLUSTERS:
            for w in FUSED_WARPS:
                n = ctypes.c_int(0)
                raise_on(lib.benor_fused_fits(
                    c, w, COIN_MODES.index(coin_mode), int(equiv),
                    ctypes.byref(n)), "fused_fits")
                out[(c, w)] = n.value
    return out


@functools.cache
def fused_grid(lib, n_w: int, t: int, device, coin_mode="private",
               equiv=False) -> tuple[int, int]:
    """The fused kernel's (C, W) on ``device`` for ``n_w`` words and ``t``
    trials in ``coin_mode`` / ``equiv``: ``fused_cluster`` on the device's
    ``fused_fits``, worked out once per shape and modes."""
    return fused_cluster(n_w, t, fused_fits(lib, device, coin_mode, equiv))


def _launch_fused_round(lib, pkey, vkey, ckey, rk, hist_f, pack, m, n_faulty,
                        rule, fault_model, freeze, grid, coin_mode="private",
                        pkey2=(0, 0), vkey2=(0, 0), ne_f=None, shared_i=None,
                        eps=0.0):
    """One launch of the single-pass kernel as ``t`` clusters of C blocks
    of W warps, ``grid`` = (C, W) (``fused_grid``'s, or one a measurement
    names) -> (new plane stack, partsA int32 [T, PROP_COLS], partsB int32
    [T, VOTE_COLS])."""
    t, p, n_w = pack.shape
    if n_w * PACK_NODES_PER_WORD > FUSED_ONE_PASS_MAX_NODES:
        raise ValueError(f"fused_round: {n_w} words exceed the one-pass cap")
    new_pack = torch.empty_like(pack)
    parts_a = torch.empty((t, PROP_COLS), dtype=torch.int32,
                          device=pack.device)
    parts_b = torch.empty((t, VOTE_COLS), dtype=torch.int32,
                          device=pack.device)
    _, coin, equiv, _ = _mode_ids("sampled", coin_mode, fault_model)
    raise_on(lib.benor_fused_round(
        ptr(pack), ptr(hist_f), _opt_ptr(ne_f), _opt_ptr(shared_i),
        ptr(new_pack), ptr(parts_a), ptr(parts_b), t, p, n_w, pkey[0],
        pkey[1], pkey2[0], pkey2[1], vkey[0], vkey[1], vkey2[0], vkey2[1],
        ckey[0], ckey[1], int(rk), float(m), float(n_faulty), float(eps),
        coin, equiv, int(rule == "textbook"), *_fault_ids(fault_model),
        int(bool(freeze)), grid[0], grid[1], stream(pack.device)),
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
                  n_equiv=None, counts_mode="sampled", camp_b0=0, camp_b1=0):
    """The proposal pass -> int32 [T, PROP_COLS] summed over the node axis
    (cols 0-2 vote histogram over honest live lanes, col 3 alive count).
    ``hist``: the phase's counts in ``counts_mode``'s layout; ``n_equiv``:
    live equivocators int32 [T] (equivocate under sampled counts);
    ``camp_b0`` / ``camp_b1``: the targeted adversary's camp bounds."""
    _check_modes(fault_model, counts_mode=counts_mode, n_equiv=n_equiv)
    if on_cpu(pack.device, "round kernels"):
        return proposal_hist_plain(seed, r, phase, hist, pack, m,
                                   fault_model, freeze, n_equiv, counts_mode,
                                   camp_b0, camp_b1)
    from ._build import load_library

    _check_pack(pack)
    t = pack.shape[0]
    hist_f = kernel_vecs(hist, counts_mode)
    check("hist", hist_f, torch.float32, (t, hist_f.shape[1]), pack.device)
    key2, ne_f = _equiv_operands(seed, r, phase, n_equiv, fault_model,
                                 counts_mode, t, pack.device)
    parts = _launch_proposal_hist(load_library(), stream_scal(seed, r, phase),
                                  hist_f, pack, m, fault_model, freeze,
                                  counts_mode, key2, ne_f,
                                  (camp_b0, camp_b1))
    proposal_hist.launches += 1
    return parts.sum(0, dtype=torch.int32)


def vote_commit(seed, r, phase, hist, pack, quorum_ok, m, n_faulty, rule,
                fault_model, freeze, n_equiv=None, counts_mode="sampled",
                camp_b0=0, camp_b1=0, coin_mode="private", eps=0.0,
                shared=None):
    """The vote pass + commit -> (new plane stack, int32 [T, VOTE_COLS]
    summed over the node axis).  ``shared``: the trial's shared coin bit
    [T] (common and weak_common coins, ``eps`` the weak coin's deviation
    rate)."""
    _check_modes(fault_model, rule, counts_mode, coin_mode, eps, n_equiv,
                 shared)
    if on_cpu(pack.device, "round kernels"):
        return vote_commit_plain(seed, r, phase, hist, pack, quorum_ok, m,
                                 n_faulty, rule, fault_model, freeze,
                                 n_equiv, counts_mode, camp_b0, camp_b1,
                                 coin_mode, eps, shared)
    from ._build import load_library

    _check_pack(pack)
    t = pack.shape[0]
    hist_f = kernel_vecs(hist, counts_mode)
    qok = quorum_ok.to(torch.int32).contiguous()
    check("hist", hist_f, torch.float32, (t, hist_f.shape[1]), pack.device)
    check("quorum_ok", qok, torch.int32, (t,), pack.device)
    key2, ne_f = _equiv_operands(seed, r, phase, n_equiv, fault_model,
                                 counts_mode, t, pack.device)
    new_pack, parts = _launch_vote_commit(
        load_library(), stream_scal(seed, r, phase),
        stream_scal(seed, r, _COIN_SALT), r + 1, hist_f, qok, pack, m,
        n_faulty, rule, fault_model, freeze, counts_mode, coin_mode, key2,
        ne_f, _shared_i(None if coin_mode == "private" else shared, t,
                        pack.device), eps, (camp_b0, camp_b1))
    vote_commit.launches += 1
    return new_pack, parts.sum(0, dtype=torch.int32)


def fused_round(seed, r, hist1, pack, m, n_faulty, rule, fault_model,
                freeze, n_equiv=None, coin_mode="private", eps=0.0,
                shared=None):
    """A whole round in one kernel (sampled counts) -> (new plane stack,
    partsA [T, PROP_COLS], partsB [T, VOTE_COLS])."""
    _check_modes(fault_model, rule, "sampled", coin_mode, eps, n_equiv,
                 shared)
    if on_cpu(pack.device, "round kernels"):
        return fused_round_plain(seed, r, hist1, pack, m, n_faulty, rule,
                                 fault_model, freeze, n_equiv, coin_mode,
                                 eps, shared)
    from ._build import load_library

    _check_pack(pack)
    t, _, n_w = pack.shape
    hist_f = count_vecs(hist1)
    check("hist1", hist_f, torch.float32, (t, 3), pack.device)
    pkey2, ne_f = _equiv_operands(seed, r, rng.PHASE_PROPOSAL, n_equiv,
                                  fault_model, "sampled", t, pack.device)
    vkey2, _ = _equiv_operands(seed, r, rng.PHASE_VOTE, n_equiv,
                               fault_model, "sampled", t, pack.device)
    lib = load_library()
    grid = fused_grid(lib, n_w, t, pack.device, coin_mode, ne_f is not None)
    out = _launch_fused_round(
        lib, stream_scal(seed, r, rng.PHASE_PROPOSAL),
        stream_scal(seed, r, rng.PHASE_VOTE),
        stream_scal(seed, r, _COIN_SALT), r + 1, hist_f, pack, m, n_faulty,
        rule, fault_model, freeze, grid, coin_mode, pkey2, vkey2, ne_f,
        _shared_i(None if coin_mode == "private" else shared, t,
                  pack.device), eps)
    fused_round.launches += 1
    return out


proposal_hist.launches = 0
vote_commit.launches = 0
fused_round.launches = 0

#: The kernel wrappers, by name (their launch counters are ``.launches``).
KERNELS = {"proposal_hist": proposal_hist, "vote_commit": vote_commit,
           "fused_round": fused_round}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


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


def packed_round(cfg, pack, seed, r, hist1, n_local, n_equiv=None):
    """One round over the plane stack -> (new_pack, next round's proposal
    histogram int32 [T, 3], unsettled int32 [T]).  The single-pass kernel
    within the caps (sampled counts), else the two-kernel path with the
    node-axis sum (and the quorum gate n_alive >= m) between the passes.
    Under the count-controlling adversaries the kernels get each phase's
    closed-form counts (``tally.adversarial_counts``: 'delivered';
    ``tally.targeted_camp_triples`` and the camp bounds: 'camps'), the
    live equivocators ``n_equiv`` their free pool."""
    t = pack.shape[0]
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

    modes = dict(fault_model=cfg.fault_model,
                 freeze=bool(cfg.freeze_decided), n_equiv=n_equiv)
    coin = dict(coin_mode=cfg.coin_mode, eps=float(cfg.coin_eps),
                shared=shared_coin(cfg, seed, r, t, pack.device))
    if fused_one_pass_eligible(cfg, t, n_local):
        new_pack, _, parts_b = fused_round(seed, r, hist1, pack, m,
                                           cfg.n_faulty, cfg.rule, **modes,
                                           **coin)
    else:
        camps = dict(counts_mode=mode, camp_b0=camp_b0, camp_b1=camp_b1)
        parts_a = proposal_hist(seed, r, rng.PHASE_PROPOSAL,
                                kernel_counts(hist1), pack, m, **modes,
                                **camps)
        quorum_ok = parts_a[:, 3] >= m
        new_pack, parts_b = vote_commit(
            seed, r, rng.PHASE_VOTE, kernel_counts(parts_a[:, :3]), pack,
            quorum_ok, m, cfg.n_faulty, cfg.rule, **modes, **camps, **coin)
    return new_pack, parts_b[:, :3], parts_b[:, 4]


def run_packed_slice(cfg, state, faults, seed, from_round, until_round):
    """The packed round loop from ``from_round``, stopping before
    ``until_round`` -> (next_round, NetState).

    The JAX package runs this loop on the device (lax.while_loop); here it
    runs on the host and reads the unsettled count once per round — the
    one synchronisation per round, with the same predicate
    ``(r <= max_rounds) & (unsettled > 0) & (r < until_round)``.  The live
    equivocators are counted once, before the loop (the killed and faulty
    planes never change)."""
    n_local = state.x.shape[-1]
    pack = pack_state(cfg, state, faults.faulty)
    n_equiv = n_equiv_from_pack(cfg, pack)
    hist1 = sent_hist_from_pack(cfg, pack)
    unsettled = int(unsettled_from_pack(pack))
    r = int(from_round)
    while r <= cfg.max_rounds and r < until_round and unsettled > 0:
        pack, hist1, unsett = packed_round(cfg, pack, seed, r, hist1,
                                           n_local, n_equiv)
        unsettled = int(unsett.sum())
        r += 1
    return r, unpack_state(pack, n_local)
