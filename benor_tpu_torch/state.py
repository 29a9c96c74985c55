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
class DynParams:
    """The dynamic protocol parameters of a batched sweep (state.py:45-95):
    the fault bound F, the quorum N - F, the committee count g and target
    size c (read only under ``cfg.committee_cap``) and the omission
    probability (read only under ``cfg.drop_prob``), as tensors of the JAX
    dtypes — int32 four times, float32 for ``drop_prob``.  0-dim from
    ``from_config``, [B] from ``stack``.

    Handed to ``sim.run_consensus_traced``, they take the place of the
    config's values in the round (the decide bar, the quorum gate, the
    closed-form adversaries, the CF samplers, the committee draw, the
    omission thinning), while the config keeps every shape and mode
    decision.  A quorum held in a tensor never picks the exact shared
    tables, as a traced quorum never does in the JAX package
    (``sampling.static_m``)."""

    n_faulty: torch.Tensor         # int32 — F
    quorum: torch.Tensor           # int32 — N - F
    committee_count: torch.Tensor  # int32 — g
    committee_size: torch.Tensor   # int32 — c
    drop_prob: torch.Tensor        # float32 — p

    @classmethod
    def from_config(cls, cfg: SimConfig, device=None) -> "DynParams":
        return cls.stack([cfg], device).at(0)

    @classmethod
    def stack(cls, cfgs, device=None) -> "DynParams":
        """[B]-batched params from per-point configs."""
        def col(vals, dtype):
            return torch.from_numpy(np.asarray(vals, dtype)).to(device)
        return cls(
            n_faulty=col([c.n_faulty for c in cfgs], np.int32),
            quorum=col([c.quorum for c in cfgs], np.int32),
            committee_count=col([c.committee_count for c in cfgs], np.int32),
            committee_size=col([c.committee_size for c in cfgs], np.int32),
            drop_prob=col([c.drop_prob for c in cfgs], np.float32))

    def at(self, j: int) -> "DynParams":
        """Point ``j`` of a stacked batch, as 0-dim tensors."""
        return DynParams(*(getattr(self, f.name)[j]
                           for f in dataclasses.fields(self)))


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


# --------------------------------------------------------------------------
# Flight recorder (SimConfig.record): one int32 row a round.
#
# Row 0 is the post-/start snapshot; row r (1-based) the network at the end
# of round r; unwritten rows stay all zero (a written row's decided + killed
# + undecided classes sum to T * N >= 1).  Port of benor_tpu/state.py:
# 302-415, single-device: the loops write a row in place at round r.
# --------------------------------------------------------------------------

#: Recorder column layout — name -> (base, width), the JAX package's table.
#: Every column is a count over trials and nodes except tally_margin: the
#: sum over trials of each trial's largest |v0 - v1| over the lanes that ran
#: the vote phase (0 on row 0).
REC_LAYOUT = {
    "decided": (0, 1),      # decided lanes (cumulative)
    "killed": (1, 1),       # killed lanes
    "undecided_0": (2, 1),  # live undecided lanes holding x=0
    "undecided_1": (3, 1),  # live undecided lanes holding x=1
    "undecided_q": (4, 1),  # live undecided lanes holding "?"
    "coin_flips": (5, 1),   # lanes that committed a coin flip this round
    "tally_margin": (6, 1),  # tally-margin summary (see above)
}

REC_DECIDED = REC_LAYOUT["decided"][0]
REC_KILLED = REC_LAYOUT["killed"][0]
REC_UNDEC0 = REC_LAYOUT["undecided_0"][0]
REC_UNDEC1 = REC_LAYOUT["undecided_1"][0]
REC_UNDECQ = REC_LAYOUT["undecided_q"][0]
REC_COINS = REC_LAYOUT["coin_flips"][0]
REC_MARGIN = REC_LAYOUT["tally_margin"][0]
REC_WIDTH = max(b + w for b, w in REC_LAYOUT.values())
#: Column names, index-aligned with the REC_* constants.
REC_COLUMNS = tuple(sorted(REC_LAYOUT, key=lambda c: REC_LAYOUT[c][0]))


def recorder_snapshot_row(x: torch.Tensor, decided: torch.Tensor,
                          killed: torch.Tensor) -> torch.Tensor:
    """Recorder row from state fields [T, N] -> int32 [REC_WIDTH]: the
    class counts, with no coin flips and no margin (row 0)."""
    undec = ~decided & ~killed
    cols = [decided, killed, undec & (x == VAL0), undec & (x == VAL1),
            undec & (x == VALQ)]
    counts = [c.sum(dtype=torch.int32) for c in cols]
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return torch.stack(counts + [zero, zero])


def recorder_round_row(x: torch.Tensor, decided: torch.Tensor,
                       killed: torch.Tensor, coined: torch.Tensor,
                       margin: torch.Tensor) -> torch.Tensor:
    """End-of-round recorder row -> int32 [REC_WIDTH]: the committed fields,
    ``coined`` bool [T, N] (the lanes that committed a coin flip) and
    ``margin`` int32 [T, N] (each vote-phase lane's |v0 - v1|, else 0),
    whose per-trial max is summed over trials."""
    row = recorder_snapshot_row(x, decided, killed)
    row[REC_COINS] = coined.sum(dtype=torch.int32)
    row[REC_MARGIN] = margin.amax(-1).sum(dtype=torch.int32)
    return row


def recorder_write(recorder: torch.Tensor, r: int,
                   row: torch.Tensor) -> torch.Tensor:
    """Write ``row`` at round index ``r`` in place -> the buffer."""
    # benorlint: allow-host-sync — r is the host loop's round index, a
    # Python int (one indexed write, no read)
    recorder[int(r)] = row
    return recorder


def new_recorder(cfg: SimConfig, state: NetState) -> torch.Tensor:
    """Fresh int32 [max_rounds + 1, REC_WIDTH] buffer on the state's device
    with row 0 the snapshot of ``state``."""
    rec = torch.zeros((cfg.max_rounds + 1, REC_WIDTH), dtype=torch.int32,
                      device=state.x.device)
    rec[0] = recorder_snapshot_row(state.x, state.decided, state.killed)
    return rec


# --------------------------------------------------------------------------
# Witness recorder (SimConfig.witness_trials / witness_nodes): for every
# watched (trial, node) a row a round of the lane's committed value, its
# decided / killed / coin bits and the tallies that justified them (port of
# benor_tpu/state.py:417-560).  Row 0 is the post-/start snapshot.
# --------------------------------------------------------------------------

#: Witness column layout — name -> (base, width), the JAX package's table.
WIT_LAYOUT = {
    "x": (0, 1),        # committed protocol value (VAL0 | VAL1 | VALQ)
    "decided": (1, 1),  # decided bit
    "killed": (2, 1),   # killed bit
    "coined": (3, 1),   # lane committed a coin flip this round
    "p0": (4, 1),       # proposal-phase tally for 0
    "p1": (5, 1),       # proposal-phase tally for 1
    "v0": (6, 1),       # vote-phase tally for 0
    "v1": (7, 1),       # vote-phase tally for 1
    "written": (8, 1),  # 1 on every written row (unwritten-row sentinel)
}

WIT_X = WIT_LAYOUT["x"][0]
WIT_DECIDED = WIT_LAYOUT["decided"][0]
WIT_KILLED = WIT_LAYOUT["killed"][0]
WIT_COINED = WIT_LAYOUT["coined"][0]
WIT_P0 = WIT_LAYOUT["p0"][0]
WIT_P1 = WIT_LAYOUT["p1"][0]
WIT_V0 = WIT_LAYOUT["v0"][0]
WIT_V1 = WIT_LAYOUT["v1"][0]
WIT_WRITTEN = WIT_LAYOUT["written"][0]
WIT_WIDTH = max(b + w for b, w in WIT_LAYOUT.values())
#: Column names, index-aligned with the WIT_* constants.
WIT_COLUMNS = tuple(sorted(WIT_LAYOUT, key=lambda c: WIT_LAYOUT[c][0]))


def witness_node_ids(cfg: SimConfig) -> np.ndarray:
    """The k watched global node ids, int32 [witness_nodes], sorted: the
    first ceil(k/2) and the last floor(k/2) ids (the faulty lanes of the
    canonical masks sit at the bottom of the range, the targeted
    adversary's camps at the top)."""
    k, n = cfg.witness_nodes, cfg.n_nodes
    lo = (k + 1) // 2
    hi = k - lo
    # benorlint: allow-host-sync — static config-only ids built from host
    # ints (cfg.witness_nodes, cfg.n_nodes): no tensor is read
    return np.asarray(list(range(lo)) + list(range(n - hi, n)), np.int32)


def witness_select(cfg: SimConfig, arr: torch.Tensor) -> torch.Tensor:
    """The watched (trial, node) entries of a [T, N] field -> int32 [W, k]
    (a float tally is cast as the JAX package casts it)."""
    dev = arr.device
    wt = torch.as_tensor(cfg.witness_trials, dtype=torch.int64, device=dev)
    wn = torch.as_tensor(witness_node_ids(cfg), dtype=torch.int64,
                         device=dev)
    return arr.to(torch.int32)[wt][:, wn]


def witness_snapshot_row(cfg: SimConfig, x: torch.Tensor,
                         decided: torch.Tensor,
                         killed: torch.Tensor) -> torch.Tensor:
    """Row 0: the state fields only -> int32 [W, k, WIT_WIDTH], the written
    sentinel set."""
    fields = [witness_select(cfg, f) for f in (x, decided, killed)]
    zero = torch.zeros_like(fields[0])
    return torch.stack(fields + [zero] * 5 + [torch.ones_like(zero)], dim=-1)


def witness_round_row(cfg: SimConfig, x, decided, killed, coined, p0, p1,
                      v0, v1) -> torch.Tensor:
    """End-of-round witness row -> int32 [W, k, WIT_WIDTH]: the committed
    fields, the coin-commit mask and the lanes' proposal / vote tallies."""
    fields = [witness_select(cfg, f)
              for f in (x, decided, killed, coined, p0, p1, v0, v1)]
    return torch.stack(fields + [torch.ones_like(fields[0])], dim=-1)


def witness_write(witness: torch.Tensor, r: int,
                  row: torch.Tensor) -> torch.Tensor:
    """Write one [W, k, WIT_WIDTH] row at round index ``r`` in place -> the
    buffer."""
    # benorlint: allow-host-sync — r is the host loop's round index, a
    # Python int (one indexed write, no read)
    witness[int(r)] = row
    return witness


def new_witness(cfg: SimConfig, state: NetState) -> torch.Tensor:
    """Fresh int32 [max_rounds + 1, W, k, WIT_WIDTH] buffer on the state's
    device with row 0 the snapshot of ``state``."""
    wit = torch.zeros((cfg.max_rounds + 1, len(cfg.witness_trials),
                       cfg.witness_nodes, WIT_WIDTH), dtype=torch.int32,
                      device=state.x.device)
    wit[0] = witness_snapshot_row(cfg, state.x, state.decided, state.killed)
    return wit
