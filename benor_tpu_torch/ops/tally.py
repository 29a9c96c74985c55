"""Gate predicates of the fused kernels (port of benor_tpu/ops/tally.py:26-105).

Kept verbatim so the port dispatches exactly where the JAX package does.
"""

from __future__ import annotations

from ..config import SimConfig
from . import sampling


def pallas_stream_active(cfg: SimConfig) -> bool:
    """The uniform-scheduler quorum-delivery CF regime every fused
    histogram-path kernel serves."""
    return (cfg.use_pallas_hist and cfg.scheduler == "uniform"
            and cfg.delivery == "quorum"
            and cfg.resolved_path == "histogram"
            and cfg.quorum > sampling.EXACT_TABLE_MAX)


def pallas_hist_active(cfg: SimConfig) -> bool:
    """True iff the fused sampler serves this config's histogram tallies."""
    return pallas_stream_active(cfg) and cfg.fault_model != "equivocate"


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
