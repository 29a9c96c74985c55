"""Simulation entry points (port of benor_tpu/sim.py:189-192, 245-283, 439-457).

The port serves the packed main path: the fused round kernels in the
uniform-scheduler CF regime, private coin, crash or byzantine faults, either
decision rule, freeze on or off.  Every other regime raises
``NotImplementedError`` naming the ROADMAP item that will bring it; nothing
falls back to another path.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import SimConfig
from .ops import tally
from .state import FaultSpec, NetState, init_state


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller names another.  With
    no CUDA device and no explicit ``"cpu"`` this raises — a run never
    moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "benor_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain torch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to benor_tpu_torch yet (ROADMAP Queue A "
        f"item {item})")


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError unless the packed main path serves cfg."""
    if cfg.mesh_shape is not None:
        _unsupported("mesh_shape (sharded runs)", "15")
    if cfg.record or cfg.witness or cfg.kernel_telemetry:
        _unsupported("record / witness / kernel_telemetry", "11")
    if cfg.debug:
        _unsupported("debug=True (the per-round XLA loop)", "5")
    if not tally.pallas_round_active(cfg):
        if cfg.resolved_path == "dense":
            _unsupported("the dense path", "9")
        _unsupported("the unfused round loop (use_pallas_round=False or a "
                     "regime the fused kernels do not serve)", "5")
    if tally.pallas_round_counts_mode(cfg) != "sampled":
        _unsupported(f"scheduler={cfg.scheduler!r} (closed-form counts)",
                     "8")
    if cfg.fault_model not in ("crash", "byzantine"):
        _unsupported(f"fault_model={cfg.fault_model!r}", "8")
    if cfg.coin_mode != "private":
        _unsupported(f"coin_mode={cfg.coin_mode!r}", "8")


def start_state(cfg: SimConfig, state: NetState) -> NetState:
    """The /start transition: live lanes set k=1."""
    k = torch.where(~state.killed, torch.ones_like(state.k), state.k)
    return NetState(x=state.x, decided=state.decided, k=k,
                    killed=state.killed)


def run_consensus(cfg: SimConfig, state: NetState, faults: FaultSpec):
    """Run from /start to termination or the round cap on the device the
    state lives on -> (rounds_executed, final_state).  cfg.seed keys every
    stream exactly as ``jax.random.key(cfg.seed)`` keys the JAX package's."""
    from .ops.packed_round import run_packed

    check_supported(cfg)
    return run_packed(cfg, state, faults, cfg.seed)


def simulate(cfg: SimConfig, initial_values, faulty_list=None,
             faults: Optional[FaultSpec] = None, device=None):
    """One-shot run: build state, run, return (rounds, state, faults).

    ``faulty_list`` is the reference's launch-time fault vector; pass
    ``faults`` for per-trial specs.  Runs on CUDA unless ``device`` names
    the CPU."""
    dev = resolve_device(device)
    check_supported(cfg)
    if faults is None:
        if faulty_list is None:
            faulty_list = [False] * cfg.n_nodes
        faults = FaultSpec.from_faulty_list(cfg, faulty_list, device=dev)
    else:
        faults = faults.to(dev)
    state = init_state(cfg, initial_values, faults)
    rounds, final = run_consensus(cfg, state, faults)
    return rounds, final, faults
