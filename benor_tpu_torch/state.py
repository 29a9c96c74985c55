"""Node-state tensors and the bit-plane pack layout (port of benor_tpu/state.py).

All N nodes x T Monte-Carlo trials live in structure-of-arrays tensors:

    x:       int8  [T, N]   protocol value, VAL0 | VAL1 | VALQ
    decided: bool  [T, N]
    k:       int32 [T, N]   round counter as observed (0 before /start)
    killed:  bool  [T, N]   birth-faulty crash lanes

``PACK_LAYOUT`` is the JAX package's bit-plane table verbatim: the round
kernels (ops/packed_round.py, csrc/round_kernels.cu) read and write a
[T, planes, Np/32] stack of 32-bit words in which plane ``base + b`` holds
bit ``b`` of the named field for 32 nodes per word.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import SimConfig, VAL0, VAL1, VALQ


@dataclasses.dataclass
class NetState:
    """All node state. Leading axis T = trials, second axis N = nodes."""

    x: torch.Tensor        # int8  [T, N]
    decided: torch.Tensor  # bool  [T, N]
    k: torch.Tensor        # int32 [T, N]
    killed: torch.Tensor   # bool  [T, N]


@dataclasses.dataclass
class FaultSpec:
    """Fault-injection masks: ``faulty`` bool [T, N] (the reference's
    faultyList), ``crash_round`` int32 [T, N] (crash_at_round /
    crash_recover only, else zeros), ``recover_round`` int32 [T, N] or None
    (crash_recover only)."""

    faulty: torch.Tensor
    crash_round: torch.Tensor
    recover_round: Optional[torch.Tensor] = None

    @classmethod
    def from_faulty_list(cls, cfg: SimConfig, faulty_list,
                         crash_rounds=None, recover_rounds=None,
                         device=None) -> "FaultSpec":
        f = np.asarray(faulty_list, dtype=bool)
        if f.shape != (cfg.n_nodes,):
            raise ValueError("faultyList length must equal N (launchNodes.ts:10-11)")
        if int(f.sum()) != cfg.n_faulty:
            raise ValueError("faultyList doesnt have F faulties")
        shape = (cfg.trials, cfg.n_nodes)

        def lanes(a, dtype):
            return torch.from_numpy(np.array(np.broadcast_to(a, shape))).to(
                device=device, dtype=dtype)

        recover_round = None
        if cfg.fault_model in ("crash_at_round", "crash_recover"):
            if crash_rounds is None:
                raise ValueError(
                    f"fault_model={cfg.fault_model!r} requires crash_rounds "
                    "(int[N], round at which each faulty node dies; <=0 = never)")
            cr = np.asarray(crash_rounds, dtype=np.int32)
            if cr.shape != (cfg.n_nodes,):
                raise ValueError("crash_rounds length must equal N")
            crash_round = lanes(cr, torch.int32)
            if cfg.fault_model == "crash_recover":
                if recover_rounds is None:
                    raise ValueError(
                        "fault_model='crash_recover' requires recover_rounds")
                rr = np.asarray(recover_rounds, dtype=np.int32)
                if rr.shape != (cfg.n_nodes,):
                    raise ValueError("recover_rounds length must equal N")
                recover_round = lanes(rr, torch.int32)
        elif crash_rounds is not None:
            raise ValueError(
                "crash_rounds only applies to fault_model='crash_at_round'"
                " / 'crash_recover'")
        else:
            crash_round = torch.zeros(shape, dtype=torch.int32, device=device)
        if recover_rounds is not None and recover_round is None:
            raise ValueError(
                "recover_rounds only applies to fault_model='crash_recover'")
        return cls(faulty=lanes(f, torch.bool), crash_round=crash_round,
                   recover_round=recover_round)

    @classmethod
    def first_f(cls, cfg: SimConfig, crash_rounds=None, recover_rounds=None,
                device=None) -> "FaultSpec":
        """Mark the first ``cfg.n_faulty`` lanes faulty."""
        mask = np.zeros(cfg.n_nodes, bool)
        mask[:cfg.n_faulty] = True
        return cls.from_faulty_list(cfg, mask, crash_rounds, recover_rounds,
                                    device=device)

    @classmethod
    def none(cls, trials: int, n_nodes: int, device=None) -> "FaultSpec":
        """Zero-crash spec: every node alive, F purely a protocol parameter."""
        return cls(
            faulty=torch.zeros((trials, n_nodes), dtype=torch.bool,
                               device=device),
            crash_round=torch.zeros((trials, n_nodes), dtype=torch.int32,
                                    device=device))

    def to(self, device) -> "FaultSpec":
        rec = (None if self.recover_round is None
               else self.recover_round.to(device))
        return FaultSpec(self.faulty.to(device), self.crash_round.to(device),
                         rec)


# --------------------------------------------------------------------------
# Packed node state: the bit-plane layout (JAX state.py:240-300 verbatim).
# --------------------------------------------------------------------------

PACK_LAYOUT = {
    "x": (0, 2),        # protocol value VAL0 | VAL1 | VALQ
    "decided": (2, 1),  # decided bit
    "killed": (3, 1),   # killed bit (pad lanes carry it too)
    "coined": (4, 1),   # lane committed a coin flip this round
    "faulty": (5, 1),   # fault mask (byzantine flip / equivocator tag)
    "down": (6, 1),     # crash_recover down-interval bit (stored round)
    "k": (7, 25),       # round counter, low bit first (width = the cap)
}

PACK_EXTRA_FIELDS = ("faulty", "coined", "down")

PACK_X = PACK_LAYOUT["x"][0]
PACK_DECIDED = PACK_LAYOUT["decided"][0]
PACK_KILLED = PACK_LAYOUT["killed"][0]
PACK_COINED = PACK_LAYOUT["coined"][0]
PACK_FAULTY = PACK_LAYOUT["faulty"][0]
PACK_DOWN = PACK_LAYOUT["down"][0]
PACK_K = PACK_LAYOUT["k"][0]
PACK_K_MAX_BITS = PACK_LAYOUT["k"][1]
#: Planes below the (variable-width) k field — the hot protocol bits.
PACK_STATIC_WIDTH = PACK_K
#: Nodes per 32-bit plane word.
PACK_NODES_PER_WORD = 32


def pack_k_bits_for(max_rounds: int) -> int:
    """Planes a round counter capped at ``max_rounds`` needs (k reaches
    max_rounds + 1, low bit first)."""
    return max(int(max_rounds + 1).bit_length(), 1)


def pack_k_bits(cfg: SimConfig) -> int:
    return pack_k_bits_for(cfg.max_rounds)


def pack_width(cfg: SimConfig) -> int:
    """Total planes of a packed stack: the static bits + the k planes."""
    return PACK_STATIC_WIDTH + pack_k_bits(cfg)


def _values_array(initial_values) -> np.ndarray:
    """Initial values as a numeric array of their own shape ("?" -> VALQ);
    numeric input is passed through without a copy."""
    arr = np.asarray(initial_values)
    if arr.dtype.kind not in "iub":
        arr = np.asarray([VALQ if v == "?" else int(v) for v in np.ravel(arr)],
                         dtype=np.int64).reshape(arr.shape)
    elif arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.astype(np.int64)    # torch compares few unsigned types
    return np.ascontiguousarray(arr)


def init_state(cfg: SimConfig, initial_values, faults: FaultSpec) -> NetState:
    """Build the T x N state tensors from per-node initial values (0/1/"?"
    per node, shape [N] or [T, N]) on the device ``faults`` lives on.
    Crash-faulty lanes are killed at birth.  The values are uploaded as
    given, then checked and broadcast to [T, N] on the device."""
    device = faults.faulty.device
    vals = torch.from_numpy(_values_array(initial_values)).to(device)
    if not bool(((vals == VAL0) | (vals == VAL1) | (vals == VALQ)).all()):
        raise ValueError(
            "initial_values must be 0, 1 or '?' (reference src/types.ts:8)")
    shape = (cfg.trials, cfg.n_nodes)
    if vals.dim() == 1:
        if tuple(vals.shape) != (cfg.n_nodes,):
            raise ValueError("Arrays don't match")
    elif tuple(vals.shape) != shape:
        raise ValueError("initial_values must be [N] or [T, N]")
    x = torch.empty(shape, dtype=torch.int8, device=device)
    x.copy_(vals.expand(shape))

    killed = (faults.faulty.clone() if cfg.fault_model == "crash"
              else torch.zeros(shape, dtype=torch.bool, device=device))
    return NetState(
        x=x,
        decided=torch.zeros(shape, dtype=torch.bool, device=device),
        k=torch.zeros(shape, dtype=torch.int32, device=device),
        killed=killed,
    )


def observable_state(cfg: SimConfig, state: NetState, faults: FaultSpec,
                     node_id: int, trial: int = 0) -> dict:
    """The reference's ``/getState`` JSON for one node (node.ts:197-199;
    port of benor_tpu/state.py:581-598) as plain Python values.
    Birth-faulty crash nodes project to all-null (node.ts:21-26)."""
    if cfg.fault_model == "crash" and bool(faults.faulty[trial, node_id]):
        return {"killed": True, "x": None, "decided": None, "k": None}
    x = int(state.x[trial, node_id].item())
    return {
        "killed": bool(state.killed[trial, node_id].item()),
        "x": "?" if x == VALQ else x,
        "decided": bool(state.decided[trial, node_id].item()),
        "k": int(state.k[trial, node_id].item()),
    }
