"""The unfused Ben-Or round (port of benor_tpu/models/benor.py:32-42,
143-348, 374-381).

One call advances every lane of [trials, nodes] by one full round: the
proposal phase (tallies -> majority, tie -> "?"), the vote phase (tallies
-> decide when a count exceeds F, plurality-adopt under the reference
rule, else the coin) and the commit — the reference node's ``/message``
handler, lane-vectorised with ``torch.where``.  Every tally comes from
``tally.receiver_counts`` (the broadcast or group histograms of
``delivery='all'`` and their omission thinning, the dense path's masks and
exact tally, the fused samplers of ops/hist.py or the plain samplers of
ops/sampling.py) and every coin from ops/hist.py or the ``fold_in`` chain
of ops/rng.py, on the streams the JAX package draws, so a run equals the
JAX run bit for bit (the shared tables and the quantile up to the
differing fractions ops/sampling.py states).  The counts are only read
here: under ``delivery='all'`` they may be an expanded view of a [T, 3]
histogram.  Under ``drop_prob`` or a partition a receiver that cleared
fewer than N - F messages in either phase stalls for the round (the
per-lane quorum gate; d + 1 - F of its neighbourhood under a topology).

Structured delivery (topo/): under ``cfg.topology`` the tallies come from
each receiver's d + 1 graph neighbourhood (``receiver_counts`` dispatches
to topo/deliver.py); under ``cfg.committee_cap`` from this round's sampled
committee, whose membership is drawn once a round and masks ``active``,
so non-participants sit the round out with frozen state.  The decide rule
is unchanged: count > F, read against the neighbourhood or committee.

Every fault model is served: ``crash`` (killed at birth), ``byzantine``,
``equivocate``, ``crash_at_round`` (a lane dies at the start of its crash
round) and ``crash_recover`` (down-intervals with durable or amnesia
rejoins, faults/recovery.py), liveness re-derived from the round bounds at
the start of every round.  A round writes the flight recorder's row and
the witness row when it is handed their buffers (benor.py:349-370).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ, unported
from ..faults.recovery import rejoin_mode
from ..ops import hist as hist_ops
from ..ops import rng, tally
from ..state import (DynParams, FaultSpec, NetState, recorder_round_row,
                     recorder_write, witness_select, witness_write)
from ..topo import committees
from ..topo.graphs import parse_topology

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
    lacks for ``cfg``, or None: only a fault model it does not know."""
    if cfg.fault_model not in _FAULT_MODELS:
        return f"fault_model={cfg.fault_model!r}", "8"
    return None


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
                seed: int, r: int, recorder: Optional[torch.Tensor] = None,
                witness: Optional[torch.Tensor] = None,
                dyn: Optional[DynParams] = None):
    """Advance every lane by one full Ben-Or round (proposal + vote).

    ``r`` is the 1-based round index (the reference's message ``k``);
    ``seed`` keys every stream as ``jax.random.key(seed)`` keys the JAX
    package's.  Killed lanes stay killed.  With a ``recorder`` (state.
    new_recorder) the round writes its row at index ``r`` and the return
    is ``(new_state, recorder)``; a ``witness`` buffer (state.new_witness)
    is written the same way and returned after it.  Both only reduce what
    the round computes: no stream moves.  ``dyn`` (``state.DynParams`` or
    None) supplies F, the quorum, the committee knobs and the omission
    probability in place of the config's (benor.py:98-99, 206-207), for
    the batched sweep; the config still chooses every branch."""
    gap = round_gap(cfg)
    if gap is not None:
        unported(*gap)
    t, n = state.x.shape
    f, m = (cfg.n_faulty, cfg.quorum) if dyn is None else \
        (dyn.n_faulty, dyn.quorum)
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

    # committee delivery: this round's membership, drawn once for both
    # phases; non-participants sit the round out and go silent
    member = com_id = None
    if cfg.committee_cap:
        g, c = ((cfg.committee_count, cfg.committee_size) if dyn is None
                else (dyn.committee_count, dyn.committee_size))
        member, com_id = committees.membership(
            cfg, seed, r, rng.ids(t, device=x_cur.device),
            rng.ids(n, device=x_cur.device), g, c)
        active = active & member

    equiv = faults.faulty if cfg.fault_model == "equivocate" else None
    n_equiv = (equiv & alive).sum(-1, dtype=torch.int32) \
        if equiv is not None else None

    def counts(phase, sent):
        if member is not None:
            return committees.committee_counts(cfg, sent, alive & member,
                                               com_id)
        return tally.receiver_counts(cfg, seed, r, phase, sent, alive,
                                     equiv, n_equiv, dyn=dyn)

    # --- phase 1: proposal -----------------------------------------------
    sent1 = _sent_values(cfg, x_cur, faults)
    cnt1 = counts(rng.PHASE_PROPOSAL, sent1)                 # [T, N, 3]
    p0, p1 = cnt1[..., 0], cnt1[..., 1]
    # majority -> value, tie -> "?"
    x1 = torch.where(p0 > p1, VAL0,
                     torch.where(p1 > p0, VAL1, VALQ)).to(torch.int8)
    # omission and partitions make the delivered count per-receiver
    # random or group-bounded: keep each lane's phase-1 total for the
    # per-lane quorum gate below
    got1 = (cnt1.sum(-1) if cfg.drop_prob or cfg.partition is not None
            else None)
    # the witness keeps the watched lanes' proposal tallies
    wit_p = ((witness_select(cfg, p0), witness_select(cfg, p1))
             if witness is not None else None)
    del cnt1, p0, p1           # free the [T, N, 3] counts before phase 2

    # --- phase 2: vote -----------------------------------------------------
    # a frozen decided lane keeps vouching for its decided value
    vote_val = torch.where(frozen, x_cur, x1)
    sent2 = _sent_values(cfg, vote_val, faults)
    cnt2 = counts(rng.PHASE_VOTE, sent2)
    v0, v1 = cnt2[..., 0], cnt2[..., 1]
    if got1 is not None:
        # per-lane quorum gate: a receiver that cleared fewer than N - F
        # messages in either phase stalls this round (commits only); under
        # a topology the bar is d + 1 - F of the d + 1 neighbourhood
        bar = (parse_topology(cfg.topology).degree + 1 - f
               if cfg.topology is not None else m)
        active = active & (got1 >= bar) & (cnt2.sum(-1) >= bar)

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
    new_state = NetState(x=new_x, decided=new_decided, k=new_k,
                         killed=killed)
    if recorder is None and witness is None:
        return new_state
    # the lanes that committed a coin flip: ran the round, no decide and
    # (reference rule) no plurality-adopt, as the x2 selection above
    coined = active & ~decide0 & ~decide1
    if cfg.rule == "reference":
        coined = coined & ~adopt0 & ~adopt1
    extras = []
    if recorder is not None:
        margin = torch.where(active, (v0 - v1).abs(), 0).to(torch.int32)
        extras.append(recorder_write(recorder, r, recorder_round_row(
            new_x, new_decided, killed, coined, margin)))
    if witness is not None:
        fields = [witness_select(cfg, f)
                  for f in (new_x, new_decided, killed, coined)]
        wv = [witness_select(cfg, v) for v in (v0, v1)]
        extras.append(witness_write(witness, r, torch.stack(
            fields + list(wit_p) + wv + [torch.ones_like(fields[0])],
            dim=-1)))
    return (new_state, *extras)


def all_settled(state: NetState) -> torch.Tensor:
    """True (a 0-dim bool tensor) when every lane is decided or dead — the
    loop's termination predicate."""
    return (state.decided | state.killed).all()
