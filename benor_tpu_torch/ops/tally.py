"""Gate predicates and the histogram-path tally (port of
benor_tpu/ops/tally.py:26-133, 150-375).

The gates are kept verbatim so the port dispatches exactly where the JAX
package does.  ``receiver_counts`` serves the uniform-scheduler CF regime
of the histogram path — the fused samplers of ops/hist.py — and raises
``NotImplementedError`` naming the ROADMAP item of every other branch.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ, unported
from . import hist as hist_ops
from . import sampling


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


def class_histogram(sent: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Per-trial class counts of live senders' values -> int32 [T, 3]."""
    return torch.stack([((sent == v) & alive).sum(-1, dtype=torch.int32)
                        for v in (VAL0, VAL1, VALQ)], dim=-1)


def unfused_gap(cfg: SimConfig):
    """(what, ROADMAP item) of the first branch of the unfused histogram
    round that the port lacks for ``cfg``, or None when the fused samplers
    serve every tally."""
    if cfg.topology is not None or cfg.committee_cap:
        return "topology / committee delivery", "13"
    if cfg.drop_prob or cfg.partition is not None:
        return "drop_prob / partition delivery", "13"
    if cfg.delivery == "all":
        return "delivery='all' (the broadcast histogram)", "4"
    if cfg.scheduler in ("adversarial", "targeted"):
        return f"scheduler={cfg.scheduler!r} (closed-form counts)", "8"
    if cfg.resolved_path == "dense":
        return "the dense path", "9"
    if cfg.scheduler == "biased":
        return "scheduler='biased' (the biased samplers)", "9"
    if not pallas_stream_active(cfg):
        return ("the XLA samplers (use_pallas_hist=False, or a quorum "
                "within EXACT_TABLE_MAX)"), "4"
    return None


def receiver_counts(cfg: SimConfig, seed: int, r: int, phase: int,
                    sent: torch.Tensor, alive: torch.Tensor,
                    equiv: torch.Tensor | None = None,
                    n_equiv: torch.Tensor | None = None) -> torch.Tensor:
    """Per-receiver tallied class counts int32 [T, N, 3] over the global
    sender population.  ``equiv`` (bool [T, N] or None) marks equivocating
    senders, whose slot in ``sent`` is ignored; ``n_equiv`` (int32 [T]) is
    their live count, hoisted by the caller once per round."""
    gap = unfused_gap(cfg)
    if gap is not None:
        unported(*gap)
    n = sent.shape[-1]
    honest = alive if equiv is None else (alive & ~equiv)
    if equiv is not None and n_equiv is None:
        n_equiv = (equiv & alive).sum(-1, dtype=torch.int32)
    hist = class_histogram(sent, honest)
    if equiv is not None:
        return hist_ops.equiv_counts(seed, r, phase, hist, n_equiv,
                                     cfg.quorum, n)
    return hist_ops.cf_counts(seed, r, phase, hist, cfg.quorum, n)
