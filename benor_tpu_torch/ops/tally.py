"""Gate predicates and the per-receiver tally (port of
benor_tpu/ops/tally.py:26-147, 150-375).

The gates are kept verbatim so the port dispatches exactly where the JAX
package does.  ``receiver_counts`` serves four regimes: ``delivery='all'``
without omission — every receiver tallies the trial's class histogram (plus
a Binomial(n_equiv, 1/2) split of the live equivocators), on either path —
the count-controlling adversaries (``scheduler='adversarial'`` and
``'targeted'``), whose closed forms (``adversarial_counts``,
``targeted_counts``, ported from benor_tpu/ops/tally.py:526-720) serve both
paths, the dense path under quorum delivery (uniform or biased scheduler)
or per-edge omission — an explicit [T, N, N] mask from ops/scheduler.py,
tallied exactly by ops/dense.py — and the uniform-scheduler CF regime of
the histogram path, the fused samplers of ops/hist.py.  Every other branch
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ, unported
from . import dense as dense_ops
from . import hist as hist_ops
from . import rng, sampling, scheduler


def pallas_stream_active(cfg: SimConfig) -> bool:
    """The uniform-scheduler quorum-delivery CF regime every fused
    histogram-path kernel serves."""
    return (cfg.use_pallas_hist and cfg.scheduler == "uniform"
            and cfg.delivery == "quorum"
            and cfg.resolved_path == "histogram"
            and cfg.quorum > sampling.EXACT_TABLE_MAX)


def pallas_requested(cfg: SimConfig) -> bool:
    """True iff the config asks for any fused kernel (hist or round),
    whether or not its regime can serve one."""
    return cfg.use_pallas_hist or cfg.use_pallas_round


def pallas_hist_active(cfg: SimConfig) -> bool:
    """True iff the fused sampler serves this config's histogram tallies."""
    return pallas_stream_active(cfg) and cfg.fault_model != "equivocate"


def pallas_equiv_active(cfg: SimConfig) -> bool:
    """True iff the fused equivocate-regime sampler serves this config's
    histogram tallies."""
    return pallas_stream_active(cfg) and cfg.fault_model == "equivocate"


def pallas_round_active(cfg: SimConfig) -> bool:
    """True iff the fused round kernels serve this config: a coin the
    kernels produce (private / common / weak with 0 < eps < 1) and a counts
    source they implement (the CF regime, or the closed-form
    count-controlling adversaries)."""
    if not cfg.use_pallas_round:
        return False
    if cfg.coin_mode == "weak_common":
        if not (0.0 < cfg.coin_eps < 1.0):
            return False
    elif cfg.coin_mode not in ("private", "common"):
        return False
    if pallas_stream_active(cfg):
        return True
    return (cfg.scheduler in ("adversarial", "targeted")
            and cfg.delivery == "quorum")


def pallas_round_counts_mode(cfg: SimConfig) -> str:
    """Which counts source the fused round kernels run for this config."""
    if cfg.scheduler == "adversarial":
        return "delivered"
    if cfg.scheduler == "targeted":
        return "camps"
    return "sampled"


def dense_gather_needed(cfg: SimConfig) -> bool:
    """True iff receiver_counts takes the dense masked path: quorum
    delivery under a mask-drawing scheduler, or per-edge omission."""
    if (cfg.delivery == "all" and cfg.drop_prob
            and cfg.resolved_path == "dense"):
        return True
    return (cfg.delivery == "quorum" and cfg.scheduler != "adversarial"
            and cfg.resolved_path == "dense")


def class_histogram(sent: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Per-trial class counts of live senders' values -> int32 [T, 3]."""
    return torch.stack([((sent == v) & alive).sum(-1, dtype=torch.int32)
                        for v in (VAL0, VAL1, VALQ)], dim=-1)


def dense_counts(mask: torch.Tensor, sent: torch.Tensor,
                 alive: torch.Tensor) -> torch.Tensor:
    """Exact per-receiver counts from an explicit delivery mask, as one
    [R, S] @ [S, 3] f32 product per trial (exact below 2**24 senders) ->
    int32 [T, R, 3].  The counterpart of the JAX package's XLA
    ``dense_counts``: the ``use_pallas=False`` route."""
    onehot = torch.stack([((sent == v) & alive).to(torch.float32)
                          for v in (VAL0, VAL1, VALQ)], dim=-1)  # [T, S, 3]
    return torch.bmm(mask.to(torch.float32), onehot).to(torch.int32)


def unfused_gap(cfg: SimConfig):
    """(what, ROADMAP item) of the first branch of the unfused round's
    tally that the port lacks for ``cfg``, or None when the dense masks or
    the fused samplers serve every tally."""
    if cfg.topology is not None or cfg.committee_cap:
        return "topology / committee delivery", "13"
    if cfg.partition is not None:
        return "partition delivery", "13"
    if cfg.delivery == "all":
        if cfg.drop_prob and cfg.resolved_path != "dense":
            return "drop_prob on the histogram path (binomial thinning)", "13"
        return None
    if cfg.scheduler in ("adversarial", "targeted"):
        return None                       # closed form on both paths
    if cfg.resolved_path == "dense":
        return None
    if cfg.scheduler == "biased":
        return ("scheduler='biased' on the histogram path (the biased "
                "samplers)"), "4"
    if not pallas_stream_active(cfg):
        return ("the XLA samplers (use_pallas_hist=False, or a quorum "
                "within EXACT_TABLE_MAX)"), "4"
    return None


def targeted_camp_sizes(cfg: SimConfig) -> tuple:
    """(size_per_value_camp, free_static): how many receivers the targeted
    adversary seeds per value camp.  A camp must muster count > F of its
    value at its own receivers; equivocators (free_static of them, each
    able to tell every receiver a different value) substitute for honest
    camp members one-for-one."""
    free_static = cfg.n_faulty if cfg.fault_model == "equivocate" else 0
    return max(cfg.n_faulty + 1 - free_static, 1), free_static


def targeted_camp_bounds(cfg: SimConfig) -> tuple:
    """(camp_b0, camp_b1): the first global receiver id of the 0-camp and
    of the 1-camp (the value camps sit at the top of the id range, the
    1-camp last); ids below camp_b0 form the "?" camp."""
    size_v, _ = targeted_camp_sizes(cfg)
    return (max(cfg.n_nodes - 2 * size_v, 0),
            max(cfg.n_nodes - size_v, 0))


def targeted_camp_triples(cfg: SimConfig, hist: torch.Tensor,
                          n_free: torch.Tensor | None = None) -> torch.Tensor:
    """The targeted adversary's three camp multisets as per-trial counts:
    int32 [T, 3 camps, 3 classes], camps ordered (0-camp, 1-camp,
    "?"-camp).  The 0-camp tallies its class first (honest and every free
    equivocator), then "?", the starved class last; the 1-camp mirrors it;
    the "?" camp tallies every "?" it can and fills the rest evenly, one
    "?" dropped where that makes the remainder even (a perfect tie adopts
    "?").  ``hist``: int32 [T, 3] global honest counts; ``n_free``: live
    equivocators [T] or None."""
    m = cfg.quorum
    c0, c1, cq = hist[:, 0], hist[:, 1], hist[:, 2]
    free = torch.zeros_like(c0) if n_free is None else n_free

    def value_camp(want, other):
        pref = torch.clamp_max(want + free, m)
        q = torch.minimum(cq, m - pref)
        oth = torch.minimum(other, m - pref - q)
        return pref, oth, q

    p0, o0, vq0 = value_camp(c0, c1)
    p1, o1, vq1 = value_camp(c1, c0)

    q_q = torch.clamp_max(cq + free, m)
    rem = m - q_q
    drop = (((rem % 2) == 1) & (q_q > 0)).to(q_q.dtype)
    q_q = q_q - drop
    rem = rem + drop
    tie = rem // 2
    q0 = torch.minimum(c0, tie)
    q1 = torch.minimum(c1, tie)
    left = rem - q0 - q1
    e0 = torch.minimum(torch.clamp_min(left, 0), c0 - q0)
    q0 = q0 + e0
    left = left - e0
    e1 = torch.minimum(torch.clamp_min(left, 0), c1 - q1)
    q1 = q1 + e1
    # if the classes could not absorb the parity drop, restore it
    q_q = q_q + torch.minimum(torch.clamp_min(left - e1, 0), drop)

    camp0 = torch.stack([p0, o0, vq0], dim=-1)
    camp1 = torch.stack([o1, p1, vq1], dim=-1)
    campq = torch.stack([q0, q1, q_q], dim=-1)
    return torch.stack([camp0, camp1, campq], dim=1)


def targeted_counts(cfg: SimConfig, hist: torch.Tensor,
                    node_ids: torch.Tensor,
                    n_free: torch.Tensor | None = None) -> torch.Tensor:
    """The partitioned count-controlling adversary: each receiver tallies
    its camp's triple (``targeted_camp_triples``), the camp chosen by its
    global id ``node_ids`` [N] -> int32 [T, N, 3].  Realizable as an
    explicit delivery schedule (scheduler.realize_counts_mask)."""
    trip = targeted_camp_triples(cfg, hist, n_free)
    size_v, _ = targeted_camp_sizes(cfg)
    camp1 = node_ids >= cfg.n_nodes - size_v
    camp0 = (node_ids >= cfg.n_nodes - 2 * size_v) & ~camp1
    idx = torch.where(camp1, 1, torch.where(camp0, 0, 2))
    return trip[:, idx, :]


def adversarial_counts(hist: torch.Tensor, m: int,
                       n_free: torch.Tensor | None = None) -> torch.Tensor:
    """The worst-case count-controlling scheduler: every receiver tallies
    the same multiset of m messages, its 0 and 1 counts as even as the
    histogram allows, so phase 1 yields "?" and phase 2 never passes F.
    ``n_free`` (int32 [T] or None): live equivocators, whose values the
    adversary picks outright; they top both classes up toward the common
    level min(m // 2, (h0 + h1 + free) // 2) and the rest send "?".
    ``hist``: int32 [T, 3] global honest counts -> int32 [T, 3] delivered
    counts summing to m."""
    c0, c1, cq = hist[:, 0], hist[:, 1], hist[:, 2]
    tgt = m // 2
    h0h = torch.clamp_max(c0, tgt)
    h1h = torch.clamp_max(c1, tgt)
    if n_free is not None:
        lvl = torch.clamp_max((h0h + h1h + n_free) // 2, tgt)
        b0 = torch.minimum(torch.clamp_min(lvl - h0h, 0), n_free)
        b1 = torch.minimum(torch.clamp_min(lvl - h1h, 0), n_free - b0)
        cq = cq + (n_free - b0 - b1)
        h0, h1 = h0h + b0, h1h + b1
    else:
        h0, h1 = h0h, h1h
    hq = torch.minimum(cq, m - h0 - h1)
    rem = m - h0 - h1 - hq
    extra0 = torch.minimum(rem, c0 - h0h)
    h0, rem = h0 + extra0, rem - extra0
    extra1 = torch.minimum(rem, c1 - h1h)
    h1 = h1 + extra1
    return torch.stack([h0, h1, hq], dim=-1)


def _broadcast_counts(cfg, seed, r, phase, sent, honest, equiv, n_equiv,
                      trial_ids, recv_ids):
    """``delivery='all'``: every receiver tallies every live sender, so its
    counts are the trial's histogram over honest live senders — returned
    as an expanded [T, N, 3] view of the [T, 3] histogram, never
    materialised (callers only read it).  Live equivocators add a
    Binomial(n_equiv, 1/2) class split per receiver: the exact shared table
    while ``cfg.n_faulty`` is tabulable, else the normal quantile."""
    t, n = sent.shape
    counts = class_histogram(sent, honest)[:, None, :].expand(t, n, 3)
    if equiv is None:
        return counts
    trial_ids, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                                sent.device)
    u = rng.grid_uniforms(seed, r, phase + 32, trial_ids, recv_ids)
    if cfg.n_faulty <= sampling.EXACT_TABLE_MAX:
        b1 = sampling.binomial_half_exact_shared(u, n_equiv, cfg.n_faulty)
    else:
        b1 = sampling.binomial_half(u, n_equiv[:, None])
    b0 = n_equiv[:, None] - b1
    return counts + torch.stack([b0, b1, torch.zeros_like(b1)], dim=-1)


def _dense_receiver_counts(cfg, seed, r, phase, sent, alive, honest, equiv,
                           trial_ids, recv_ids):
    """The dense path's tally: an explicit [T, N, N] delivery mask, counted
    by the kernel's wrapper under ``use_pallas``, else by the f32 matrix
    product.  The mask and its delays are freed on return, before the next
    phase allocates its own."""
    t, n = sent.shape
    tallied = dense_ops.dense_counts if cfg.use_pallas else dense_counts
    trial_ids, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                                sent.device)
    if cfg.delivery == "all":
        # omission: every (receiver, live sender) edge survives with
        # probability 1 - drop_prob; the survivors are tallied exactly.
        # equivocate is rejected with drop_prob, so honest == alive.
        mask = scheduler.omission_delivery_mask(
            cfg, seed, r, phase, alive, cfg.drop_prob, trial_ids, recv_ids)
        return tallied(mask, sent, alive)
    mask = scheduler.quorum_delivery_mask(cfg, seed, r, phase, sent, alive,
                                          trial_ids, recv_ids)
    counts = tallied(mask, sent, honest)
    if equiv is not None:
        # per-edge fair bits for the delivered equivocator messages (the
        # arrival race is content-independent: only the counted value
        # changes, not the mask)
        mask.logical_and_((equiv & alive)[:, None, :])
        bits = rng.edge_uniforms(seed, r, phase + 32, trial_ids, recv_ids,
                                 rng.ids(n, device=sent.device)) < 0.5
        c1b = (mask & bits).sum(-1, dtype=torch.int32)
        c0b = mask.sum(-1, dtype=torch.int32) - c1b
        counts = counts + torch.stack([c0b, c1b, torch.zeros_like(c0b)],
                                      dim=-1)
    return counts


def receiver_counts(cfg: SimConfig, seed: int, r: int, phase: int,
                    sent: torch.Tensor, alive: torch.Tensor,
                    equiv: torch.Tensor | None = None,
                    n_equiv: torch.Tensor | None = None,
                    trial_ids: torch.Tensor | None = None,
                    recv_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Per-receiver tallied class counts int32 [T, N, 3] over the global
    sender population.  ``equiv`` (bool [T, N] or None) marks equivocating
    senders, whose slot in ``sent`` is ignored; ``n_equiv`` (int32 [T]) is
    their live count, hoisted by the caller once per round (the histogram
    path reads it).  ``trial_ids`` / ``recv_ids``: the global ids that key
    the dense path's per-edge streams and the equivocator split's lane
    streams (default 0..T-1 / 0..N-1)."""
    gap = unfused_gap(cfg)
    if gap is not None:
        unported(*gap)
    t, n = sent.shape
    honest = alive if equiv is None else (alive & ~equiv)
    if equiv is not None and n_equiv is None:
        n_equiv = (equiv & alive).sum(-1, dtype=torch.int32)
    # the count-controlling adversaries: closed form on both paths, so the
    # scheduler's semantics do not flip where path='auto' crosses
    # dense_path_max_n; equivocators are their free pool
    if cfg.scheduler == "adversarial":
        counts = adversarial_counts(class_histogram(sent, honest),
                                    cfg.quorum, n_free=n_equiv)
        return counts[:, None, :].expand(t, n, 3)
    if cfg.scheduler == "targeted":
        _, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                            sent.device)
        return targeted_counts(cfg, class_histogram(sent, honest), recv_ids,
                               n_free=n_equiv)
    if dense_gather_needed(cfg):
        return _dense_receiver_counts(cfg, seed, r, phase, sent, alive,
                                      honest, equiv, trial_ids, recv_ids)

    if cfg.delivery == "all":
        return _broadcast_counts(cfg, seed, r, phase, sent, honest, equiv,
                                 n_equiv, trial_ids, recv_ids)
    hist = class_histogram(sent, honest)
    if equiv is not None:
        return hist_ops.equiv_counts(seed, r, phase, hist, n_equiv,
                                     cfg.quorum, n)
    return hist_ops.cf_counts(seed, r, phase, hist, cfg.quorum, n)
