"""The unfused Ben-Or round (port of benor_tpu/models/benor.py:32-42,
143-348, 374-381).

One call advances every lane of [trials, nodes] by one full round: the
proposal phase (tallies -> majority, tie -> "?"), the vote phase (tallies
-> decide when a count exceeds F, plurality-adopt under the reference
rule, else the coin) and the commit — the reference node's ``/message``
handler, lane-vectorised with ``torch.where``.  Every tally comes from
``tally.receiver_counts`` (the broadcast histogram of ``delivery='all'``,
the dense path's masks and exact tally, or the fused samplers of
ops/hist.py) and every coin from ops/hist.py or the ``fold_in`` chain of
ops/rng.py, on the streams the JAX package draws, so a run equals the JAX
run bit for bit (the ``delivery='all'`` equivocator split up to the
differing fraction ops/sampling.py states).  The counts are only read
here: under ``delivery='all'`` they are an expanded view of a [T, 3]
histogram.

Every fault model is served: ``crash`` (killed at birth), ``byzantine``,
``equivocate``, ``crash_at_round`` (a lane dies at the start of its crash
round) and ``crash_recover`` (down-intervals with durable or amnesia
rejoins, faults/recovery.py), liveness re-derived from the round bounds at
the start of every round.  The recorder, the witness and committees raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ, unported
from ..faults.recovery import rejoin_mode
from ..ops import hist as hist_ops
from ..ops import rng, tally
from ..state import FaultSpec, NetState

_FAULT_MODELS = ("crash", "byzantine", "equivocate", "crash_at_round",
                 "crash_recover")


def _flip(x: torch.Tensor) -> torch.Tensor:
    """Byzantine bit-flip: 0 <-> 1, "?" unchanged."""
    return torch.where(x == VAL0, VAL1,
                       torch.where(x == VAL1, VAL0, VALQ)).to(torch.int8)


def _sent_values(cfg: SimConfig, x: torch.Tensor,
                 faults: FaultSpec) -> torch.Tensor:
    """What each lane broadcasts: byzantine lanes flip their value."""
    if cfg.fault_model == "byzantine":
        return torch.where(faults.faulty, _flip(x), x)
    return x


def round_gap(cfg: SimConfig):
    """(what, ROADMAP item) of the first part of ``benor_round`` the port
    lacks for ``cfg``, or None."""
    if cfg.fault_model not in _FAULT_MODELS:
        return f"fault_model={cfg.fault_model!r}", "8"
    if cfg.record or cfg.witness:
        return "record / witness", "11"
    return tally.unfused_gap(cfg)


def _start_of_round(cfg: SimConfig, state: NetState, faults: FaultSpec,
                    r: int):
    """The crash-at-round / crash-recover update at the start of round
    ``r`` (benor.py:143-184) -> (killed, down or None, x).  Under
    'crash_at_round' a faulty lane with ``crash_round`` in (0, r] latches
    killed.  Under 'crash_recover' a lane whose interval has started
    latches killed if it never rejoins (``recover_round <= 0``) and is
    down this round while ``r < recover_round``; with the 'amnesia'
    rejoin an undecided lane restarts x from "?" at ``r ==
    recover_round``.  Liveness comes from the bounds, never from the
    loop's history, so sliced runs equal one-shot runs."""
    killed, x_cur = state.killed, state.x
    if cfg.fault_model == "crash_at_round":
        crashing = faults.faulty & (faults.crash_round > 0) & \
            (r >= faults.crash_round)
        return killed | crashing, None, x_cur
    if cfg.fault_model != "crash_recover":
        return killed, None, x_cur
    if faults.recover_round is None:
        raise ValueError(
            "fault_model='crash_recover' needs FaultSpec.recover_round "
            "(build the spec via faults.recovery.crash_recover_faults or "
            "FaultSpec.from_faulty_list(..., recover_rounds=...))")
    cr, rr = faults.crash_round, faults.recover_round
    started = faults.faulty & (cr > 0) & (r >= cr)
    killed = killed | (started & (rr <= 0))              # never rejoins
    down = started & (rr > 0) & (r < rr)
    if rejoin_mode(cfg.recovery) == "amnesia":
        # cr > 0: a lane with a recover bound but no crash forgets nothing
        rejoin_now = faults.faulty & (cr > 0) & (rr > 0) & (r == rr) & \
            ~state.decided
        x_cur = torch.where(rejoin_now, VALQ, x_cur)
    return killed, down, x_cur


def _coin(cfg: SimConfig, seed: int, r: int, t: int, n: int,
          device) -> torch.Tensor:
    """This round's coin per lane, int8 [T, N] (benor.py:290-323)."""
    trial_ids = rng.ids(t, device=device)
    if cfg.coin_mode == "weak_common":
        if tally.pallas_stream_active(cfg) and 0.0 < cfg.coin_eps < 1.0:
            # the fused weak-coin kernel; the per-trial shared bit is one
            # [T] draw of the fold_in chain, keyed on trial ids only
            shared = rng.coin_flips(seed, r, trial_ids,
                                    rng.ids(1, device=device),
                                    common=True)[:, 0]
            return hist_ops.weak_coin_flips(seed, r, t, n, cfg.coin_eps,
                                            shared)
        # the endpoints short-circuit to the plain common / private streams
        return rng.weak_common_coin_flips(seed, r, trial_ids,
                                          rng.ids(n, device=device),
                                          cfg.coin_eps)
    if tally.pallas_stream_active(cfg) and cfg.coin_mode == "private":
        return hist_ops.coin_flips(seed, r, t, n, device)
    return rng.coin_flips(seed, r, trial_ids, rng.ids(n, device=device),
                          common=(cfg.coin_mode == "common"))


def benor_round(cfg: SimConfig, state: NetState, faults: FaultSpec,
                seed: int, r: int) -> NetState:
    """Advance every lane by one full Ben-Or round (proposal + vote).

    ``r`` is the 1-based round index (the reference's message ``k``);
    ``seed`` keys every stream as ``jax.random.key(seed)`` keys the JAX
    package's.  Killed lanes stay killed."""
    gap = round_gap(cfg)
    if gap is not None:
        unported(*gap)
    t, n = state.x.shape
    f, m = cfg.n_faulty, cfg.quorum
    killed, down, x_cur = _start_of_round(cfg, state, faults, r)

    alive = ~killed                                          # senders
    if down is not None:
        alive = alive & ~down
    n_alive = alive.sum(-1, dtype=torch.int32)               # [T]
    # Quorum gate: a tally only fires if >= N - F messages can arrive.
    quorum_ok = (n_alive >= m)[:, None]                      # [T, 1]
    frozen = state.decided if cfg.freeze_decided else \
        torch.zeros_like(state.decided)
    active = alive & quorum_ok & ~frozen

    equiv = faults.faulty if cfg.fault_model == "equivocate" else None
    n_equiv = (equiv & alive).sum(-1, dtype=torch.int32) \
        if equiv is not None else None

    # --- phase 1: proposal -----------------------------------------------
    sent1 = _sent_values(cfg, x_cur, faults)
    cnt1 = tally.receiver_counts(cfg, seed, r, rng.PHASE_PROPOSAL, sent1,
                                 alive, equiv, n_equiv)      # [T, N, 3]
    p0, p1 = cnt1[..., 0], cnt1[..., 1]
    # majority -> value, tie -> "?"
    x1 = torch.where(p0 > p1, VAL0,
                     torch.where(p1 > p0, VAL1, VALQ)).to(torch.int8)
    # omission makes the delivered count per-receiver random: keep each
    # lane's phase-1 total for the per-lane quorum gate below
    got1 = cnt1.sum(-1) if cfg.drop_prob else None
    del cnt1, p0, p1           # free the [T, N, 3] counts before phase 2

    # --- phase 2: vote -----------------------------------------------------
    # a frozen decided lane keeps vouching for its decided value
    vote_val = torch.where(frozen, x_cur, x1)
    sent2 = _sent_values(cfg, vote_val, faults)
    cnt2 = tally.receiver_counts(cfg, seed, r, rng.PHASE_VOTE, sent2, alive,
                                 equiv, n_equiv)
    v0, v1 = cnt2[..., 0], cnt2[..., 1]
    if got1 is not None:
        # per-lane quorum gate: a receiver that cleared fewer than N - F
        # messages in either phase stalls this round (commits only)
        active = active & (got1 >= m) & (cnt2.sum(-1) >= m)

    decide0 = v0 > f
    decide1 = v1 > f
    coin = _coin(cfg, seed, r, t, n, x_cur.device)
    if cfg.rule == "reference":
        # plurality-adopt before the coin
        any_votes = (v0 + v1) > 0
        adopt0 = any_votes & (v0 > v1)
        adopt1 = any_votes & (v0 < v1)
        x2 = torch.where(decide0, VAL0,
             torch.where(decide1, VAL1,
             torch.where(adopt0, VAL0,
             torch.where(adopt1, VAL1, coin))))
    else:  # textbook: the coin whenever no value exceeds F votes
        x2 = torch.where(decide0, VAL0, torch.where(decide1, VAL1, coin))

    # --- commit ------------------------------------------------------------
    new_x = torch.where(active, x2.to(torch.int8), x_cur)
    new_decided = state.decided | (active & (decide0 | decide1))
    # k <- r + 1 for every lane that ran the round, deciding ones included
    new_k = torch.where(active, r + 1, state.k)
    return NetState(x=new_x, decided=new_decided, k=new_k, killed=killed)


def all_settled(state: NetState) -> torch.Tensor:
    """True (a 0-dim bool tensor) when every lane is decided or dead — the
    loop's termination predicate."""
    return (state.decided | state.killed).all()
