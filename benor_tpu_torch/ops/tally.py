"""Gate predicates and the per-receiver tally (port of
benor_tpu/ops/tally.py).

The gates are kept verbatim so the port dispatches exactly where the JAX
package does.  ``receiver_counts`` serves every regime of the JAX
function:

- an adjacency topology (``cfg.topology``), before every other branch:
  each receiver's d + 1 neighbourhood, gathered by topo/deliver.py
  (committees tally in models/benor.py, through topo/committees.py);
- ``delivery='all'``, on either path: every receiver tallies the trial's
  class histogram, or under a partition epoch its group's
  (``partition_counts``: [T, G, 3] sums over the sender groups); live
  equivocators add a Binomial(n_equiv, 1/2) split; ``drop_prob`` thins
  the counts by closed-form binomial draws on the histogram path
  (``omission_thin_counts``) and drops edges of an explicit mask on the
  dense path (partition epoch included);
- the count-controlling adversaries (``scheduler='adversarial'`` and
  ``'targeted'``), whose closed forms serve both paths;
- the dense path under quorum delivery (uniform or biased scheduler): an
  explicit [T, N, N] mask from ops/scheduler.py, tallied exactly by
  ops/dense.py;
- the histogram path under quorum delivery: the fused samplers of
  ops/hist.py in the uniform-scheduler CF regime, else the plain samplers
  of ops/sampling.py (the exact shared tables within EXACT_TABLE_MAX, the
  CF draws above), the biased scheduler's strict-priority
  (``biased_priority_counts``) and fractional (``biased_fractional_counts``)
  forms included.

No kernel lies on the plain samplers' branches, in either package.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ
from . import dense as dense_ops
from . import hist as hist_ops
from . import rng, sampling, scheduler
from ..faults.partitions import group_of, parse_partition


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


def kernels_active(cfg: SimConfig) -> bool:
    """True iff a run of cfg on the card may launch a hand-written kernel:
    the round kernels, the fused samplers and coins, or the dense tally
    under ``use_pallas``."""
    return (pallas_round_active(cfg) or pallas_stream_active(cfg)
            or (cfg.use_pallas and dense_gather_needed(cfg)))


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


def targeted_camp_sizes_dyn(cfg: SimConfig, dyn) -> torch.Tensor:
    """``targeted_camp_sizes``' first element from a ``DynParams`` F
    (tally.py:536-542): the per-value-camp receiver count as an int32
    0-dim tensor, the same formula."""
    free = dyn.n_faulty if cfg.fault_model == "equivocate" else 0
    return torch.clamp_min(dyn.n_faulty + 1 - free, 1)


def targeted_camp_triples(cfg: SimConfig, hist: torch.Tensor,
                          n_free: torch.Tensor | None = None,
                          dyn=None) -> torch.Tensor:
    """The targeted adversary's three camp multisets as per-trial counts:
    int32 [T, 3 camps, 3 classes], camps ordered (0-camp, 1-camp,
    "?"-camp).  The 0-camp tallies its class first (honest and every free
    equivocator), then "?", the starved class last; the 1-camp mirrors it;
    the "?" camp tallies every "?" it can and fills the rest evenly, one
    "?" dropped where that makes the remainder even (a perfect tie adopts
    "?").  ``hist``: int32 [T, 3] global honest counts; ``n_free``: live
    equivocators [T] or None; ``dyn`` (``state.DynParams`` or None)
    supplies the quorum."""
    m = cfg.quorum if dyn is None else dyn.quorum
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
                    n_free: torch.Tensor | None = None,
                    dyn=None) -> torch.Tensor:
    """The partitioned count-controlling adversary: each receiver tallies
    its camp's triple (``targeted_camp_triples``), the camp chosen by its
    global id ``node_ids`` [N] -> int32 [T, N, 3].  Realizable as an
    explicit delivery schedule (scheduler.realize_counts_mask)."""
    trip = targeted_camp_triples(cfg, hist, n_free, dyn)
    size_v = (targeted_camp_sizes(cfg)[0] if dyn is None
              else targeted_camp_sizes_dyn(cfg, dyn))
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


def partition_counts(cfg: SimConfig, part, sent: torch.Tensor,
                     honest: torch.Tensor, node_ids: torch.Tensor,
                     r: int) -> torch.Tensor:
    """Per-receiver counts under an epoch-structured partition
    (faults/partitions.py) -> int32 [T, N, 3] (tally.py:378-407).

    During the epoch (r < heal_round) each receiver tallies its own
    group's class histogram: [T, G, 3] integer sums over the sender
    groups (one ``index_add_``, never an N x N array), gathered by each
    receiver's group; from the heal round on, the whole network's
    histogram as an expanded view.  ``node_ids``: the global ids of the
    receivers, which are also the senders."""
    t, n = sent.shape
    grp = group_of(node_ids, cfg.n_nodes, part.groups)          # [N]
    cls = torch.stack([((sent == v) & honest).to(torch.int32)
                       for v in (VAL0, VAL1, VALQ)], dim=-1)    # [T, N, 3]
    ghist = torch.zeros((t, part.groups, 3), dtype=torch.int32,
                        device=sent.device).index_add_(1, grp, cls)
    if r < part.heal_round:
        return ghist[:, grp, :]
    return ghist.sum(dim=1, dtype=torch.int32)[:, None, :].expand(t, n, 3)


def omission_thin_counts(seed: int, r: int, phase: int,
                         counts: torch.Tensor, drop_p: float,
                         trial_ids: torch.Tensor,
                         node_ids: torch.Tensor) -> torch.Tensor:
    """Per-edge iid omission as closed-form binomial thinning, the
    histogram path of ``SimConfig.drop_prob`` -> int32 [T, N, 3]
    (tally.py:410-433): a receiver facing a class-v population of c_v
    tallies Binomial(c_v, 1 - p) of them, three independent draws a
    (trial, receiver, phase) on the salts phase + 8, + 24 and + 40."""
    keep = sampling._c(1.0, counts) - sampling._c(drop_p, counts)
    cols = []
    for i, salt in enumerate((8, 24, 40)):
        u = rng.grid_uniforms(seed, r, phase + salt, trial_ids, node_ids)
        cols.append(sampling.binomial_keep(u, counts[..., i], keep))
    return torch.stack(cols, dim=-1)


def _parity_split(hist: torch.Tensor, node_ids: torch.Tensor):
    """(even, favored value count, starved count) per lane [T, N] of the
    split-bias scheduler: even receivers are starved of 1s, odd ones of
    0s."""
    c0, c1 = hist[:, 0:1], hist[:, 1:2]
    even = (node_ids % 2 == 0)[None, :]
    return even, torch.where(even, c0, c1), torch.where(even, c1, c0)


def biased_priority_counts(u0: torch.Tensor, hist: torch.Tensor, m: int,
                           node_ids: torch.Tensor) -> torch.Tensor:
    """The biased scheduler at strength >= 1 (strict priority) on the
    histogram path -> int32 [T, N, 3] (tally.py:436-488): every favored
    message (the favored value and "?") arrives before every starved one,
    so a lane tallies min(favored, m) of them, split between the favored
    value and "?" by a hypergeometric draw, and fills the rest from the
    starved class.  In the exact regime the split of a lane whose favored
    population covers m comes from one exact table per parity class.

    ``u0``: f32 [T, N]; ``hist``: int32 [T, 3]; ``node_ids``: the global
    receiver ids (parity picks the starved class)."""
    ms = sampling.static_m(m)
    c0, c1, cq = hist[:, 0:1], hist[:, 1:2], hist[:, 2:3]       # [T, 1]
    even, fav_val, starved_c = _parity_split(hist, node_ids)
    fav_total = fav_val + cq
    n_fav = torch.clamp(fav_total, max=m)                       # favored
    n_starved = torch.minimum(m - n_fav, starved_c)             # the fill
    exact = ms is not None and ms <= sampling.EXACT_TABLE_MAX
    h_favval = sampling.hypergeom_normal_approx(
        u0, fav_total, fav_val, n_fav, skew_correct=not exact)
    if exact:
        h_even = sampling.hypergeom_exact_shared(
            u0, (c0 + cq)[:, 0], c0[:, 0], ms)
        h_odd = sampling.hypergeom_exact_shared(
            u0, (c1 + cq)[:, 0], c1[:, 0], ms)
        # the tables draw m; a lane whose favored population is short of
        # m draws all of it, so it keeps the per-lane draw
        h_exact = torch.where(even, h_even, h_odd)
        h_favval = torch.where(fav_total >= m, h_exact, h_favval)
    hq = n_fav - h_favval
    h0 = torch.where(even, h_favval, n_starved)
    h1 = torch.where(even, n_starved, h_favval)
    return torch.stack([h0, h1, hq], dim=-1)


def biased_fractional_counts(s: float, u_race: torch.Tensor,
                             u_split: torch.Tensor, hist: torch.Tensor,
                             m: int, node_ids: torch.Tensor) -> torch.Tensor:
    """The biased scheduler at fractional strength 0 < s < 1 on the
    histogram path -> int32 [T, N, 3] (tally.py:491-520): the favored
    count of a lane from the two-population delay race
    (``sampling.uniform_race_favored_count``), the rest from the starved
    class, the favored count split between the favored value and "?" by
    a plain hypergeometric draw.

    ``u_race`` / ``u_split``: f32 [T, N]; ``hist``: int32 [T, 3]."""
    cq = hist[:, 2:3]
    even, fav_val, starved_c = _parity_split(hist, node_ids)
    n_fav = fav_val + cq
    j = sampling.uniform_race_favored_count(u_race, n_fav, starved_c, m, s)
    k_starved = torch.minimum(m - j, starved_c)
    h_favval = sampling.hypergeom_normal_approx(u_split, n_fav, fav_val, j)
    hq = j - h_favval
    h0 = torch.where(even, h_favval, k_starved)
    h1 = torch.where(even, k_starved, h_favval)
    return torch.stack([h0, h1, hq], dim=-1)


def _broadcast_counts(cfg, seed, r, phase, sent, honest, equiv, n_equiv,
                      trial_ids, recv_ids, drop_p):
    """``delivery='all'`` off the dense omission mask: every receiver
    tallies every live sender, so its counts are the trial's histogram over
    honest live senders — or, inside a partition epoch, its group's —
    returned as an expanded [T, N, 3] view, never materialised (callers
    only read it).  ``drop_prob`` thins them by binomial draws; live
    equivocators (never with a partition or omission) add a
    Binomial(n_equiv, 1/2) class split per receiver: the exact shared
    table while ``cfg.n_faulty`` is tabulable, else the normal quantile."""
    t, n = sent.shape
    trial_ids, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                                sent.device)
    part = parse_partition(cfg.partition)
    if part is not None:
        counts = partition_counts(cfg, part, sent, honest, recv_ids, r)
    else:
        counts = class_histogram(sent, honest)[:, None, :].expand(t, n, 3)
    if cfg.drop_prob:
        return omission_thin_counts(seed, r, phase, counts, drop_p,
                                    trial_ids, recv_ids)
    if equiv is None:
        return counts
    u = rng.grid_uniforms(seed, r, phase + 32, trial_ids, recv_ids)
    if cfg.n_faulty <= sampling.EXACT_TABLE_MAX:
        b1 = sampling.binomial_half_exact_shared(u, n_equiv, cfg.n_faulty)
    else:
        b1 = sampling.binomial_half(u, n_equiv[:, None])
    b0 = n_equiv[:, None] - b1
    return counts + torch.stack([b0, b1, torch.zeros_like(b1)], dim=-1)


def _histogram_counts(cfg, seed, r, phase, sent, honest, equiv, n_equiv,
                      trial_ids, recv_ids, m, dyn):
    """The histogram path under quorum delivery (tally.py:320-375): the
    fused samplers of ops/hist.py where they serve, else the plain
    samplers — the mixed-population draw under equivocation, the biased
    scheduler's strict or fractional form, the two-class draw."""
    t, n = sent.shape
    hist = class_histogram(sent, honest)
    if dyn is not None and pallas_stream_active(cfg):
        raise ValueError(
            "dynamic-F tracing cannot drive the fused pallas samplers "
            "(the quorum is baked into the kernel closures); bucket such "
            "configs statically (sweep.quorum_specialized)")
    if equiv is not None and pallas_equiv_active(cfg):
        return hist_ops.equiv_counts(seed, r, phase, hist, n_equiv,
                                     cfg.quorum, n)
    if pallas_hist_active(cfg):
        return hist_ops.cf_counts(seed, r, phase, hist, cfg.quorum, n)
    trial_ids, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                                sent.device)

    def uniforms(salt):
        return rng.grid_uniforms(seed, r, phase + salt, trial_ids, recv_ids)

    if equiv is not None:
        u_b, u0, u1, u_s = (uniforms(salt) for salt in (32, 0, 16, 48))
        return sampling.equivocate_hypergeom_counts(u_b, u0, u1, u_s, hist,
                                                    n_equiv, m)
    u0, u1 = uniforms(0), uniforms(16)
    if cfg.scheduler == "biased":
        if cfg.adversary_strength >= 1.0:
            return biased_priority_counts(u0, hist, m, recv_ids)
        if cfg.adversary_strength > 0.0:
            return biased_fractional_counts(cfg.adversary_strength, u0, u1,
                                            hist, m, recv_ids)
        # strength 0: the dense scheduler adds no delay — plain uniform
    return sampling.multivariate_hypergeom_counts(u0, u1, hist, m)


def _dense_receiver_counts(cfg, seed, r, phase, sent, alive, honest, equiv,
                           trial_ids, recv_ids, drop_p):
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
        # probability 1 - drop_prob, and inside a partition epoch only
        # within the receiver's group; the survivors are tallied exactly.
        # equivocate is rejected with drop_prob, so honest == alive.
        mask = scheduler.omission_delivery_mask(
            cfg, seed, r, phase, alive, drop_p, trial_ids, recv_ids,
            part=parse_partition(cfg.partition))
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
                    recv_ids: torch.Tensor | None = None,
                    dyn=None) -> torch.Tensor:
    """Per-receiver tallied class counts int32 [T, N, 3] over the global
    sender population.  ``equiv`` (bool [T, N] or None) marks equivocating
    senders, whose slot in ``sent`` is ignored; ``n_equiv`` (int32 [T]) is
    their live count, hoisted by the caller once per round (the histogram
    path reads it).  ``trial_ids`` / ``recv_ids``: the global ids that key
    the dense path's per-edge streams and the equivocator split's lane
    streams (default 0..T-1 / 0..N-1).  ``dyn`` (``state.DynParams`` or
    None) supplies the quorum and the omission probability, as in the JAX
    function (tally.py:185, 219-220); the branch is still chosen by
    ``cfg``.  The branches whose work is shaped by the quorum refuse it
    with the JAX package's messages: the dense quorum mask and the fused
    samplers (the exact tables take the CF branch instead, as a traced
    quorum does there)."""
    if cfg.topology is not None:
        # each receiver tallies its d graph neighbours and itself (an
        # O(N * d) gather); delivery='all' is required, so no scheduler
        # below composes with it
        from ..topo.deliver import neighborhood_counts
        return neighborhood_counts(cfg, seed, r, phase, sent, alive, equiv,
                                   trial_ids, recv_ids)
    t, n = sent.shape
    m = cfg.quorum if dyn is None else dyn.quorum
    drop_p = cfg.drop_prob if dyn is None else dyn.drop_prob
    honest = alive if equiv is None else (alive & ~equiv)
    if equiv is not None and n_equiv is None:
        n_equiv = (equiv & alive).sum(-1, dtype=torch.int32)
    # the count-controlling adversaries: closed form on both paths, so the
    # scheduler's semantics do not flip where path='auto' crosses
    # dense_path_max_n; equivocators are their free pool
    if cfg.scheduler == "adversarial":
        counts = adversarial_counts(class_histogram(sent, honest), m,
                                    n_free=n_equiv)
        return counts[:, None, :].expand(t, n, 3)
    if cfg.scheduler == "targeted":
        _, recv_ids = scheduler.default_ids(trial_ids, recv_ids, t, n,
                                            sent.device)
        return targeted_counts(cfg, class_histogram(sent, honest), recv_ids,
                               n_free=n_equiv, dyn=dyn)
    if dense_gather_needed(cfg):
        if dyn is not None and cfg.delivery != "all":
            raise ValueError(
                "dynamic-F tracing cannot drive the dense delivery mask "
                "(top-k specializes its shape on the quorum); bucket "
                "dense-path configs statically (sweep.quorum_specialized)")
        return _dense_receiver_counts(cfg, seed, r, phase, sent, alive,
                                      honest, equiv, trial_ids, recv_ids,
                                      drop_p)

    if cfg.delivery == "all":
        return _broadcast_counts(cfg, seed, r, phase, sent, honest, equiv,
                                 n_equiv, trial_ids, recv_ids, drop_p)
    return _histogram_counts(cfg, seed, r, phase, sent, honest, equiv,
                             n_equiv, trial_ids, recv_ids, m, dyn)
