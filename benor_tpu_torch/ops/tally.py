"""Gate predicates and the per-receiver tally (port of
benor_tpu/ops/tally.py:26-147, 150-375).

The gates are kept verbatim so the port dispatches exactly where the JAX
package does.  ``receiver_counts`` serves three regimes: ``delivery='all'``
without omission — every receiver tallies the trial's class histogram (plus
a Binomial(n_equiv, 1/2) split of the live equivocators), on either path —
the dense path under quorum delivery (uniform or biased scheduler) or
per-edge omission — an explicit [T, N, N] mask from ops/scheduler.py,
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
        return f"scheduler={cfg.scheduler!r} (closed-form counts)", "8"
    if cfg.resolved_path == "dense":
        return None
    if cfg.scheduler == "biased":
        return ("scheduler='biased' on the histogram path (the biased "
                "samplers)"), "4"
    if not pallas_stream_active(cfg):
        return ("the XLA samplers (use_pallas_hist=False, or a quorum "
                "within EXACT_TABLE_MAX)"), "4"
    return None


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
    n = sent.shape[-1]
    honest = alive if equiv is None else (alive & ~equiv)
    if dense_gather_needed(cfg):
        return _dense_receiver_counts(cfg, seed, r, phase, sent, alive,
                                      honest, equiv, trial_ids, recv_ids)

    if equiv is not None and n_equiv is None:
        n_equiv = (equiv & alive).sum(-1, dtype=torch.int32)
    if cfg.delivery == "all":
        return _broadcast_counts(cfg, seed, r, phase, sent, honest, equiv,
                                 n_equiv, trial_ids, recv_ids)
    hist = class_histogram(sent, honest)
    if equiv is not None:
        return hist_ops.equiv_counts(seed, r, phase, hist, n_equiv,
                                     cfg.quorum, n)
    return hist_ops.cf_counts(seed, r, phase, hist, cfg.quorum, n)
