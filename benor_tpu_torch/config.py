"""Typed simulation configuration — the port's copy of benor_tpu/config.py.

``SimConfig`` matches the JAX package's dataclass field for field (names,
defaults, validation verdicts), so one configuration drives both packages.
It is a plain frozen dataclass: nothing here imports torch or JAX.  The
``recovery`` spec grammar is the port's copy (faults/recovery.py); the
other two structured-plane grammars (``partition``, ``topology``) are not
ported yet, and a config that sets one raises ``NotImplementedError``
where the JAX package would parse it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: TCP port of node 0 for the HTTP observation layer (node i listens on
#: BASE_NODE_PORT + i).
BASE_NODE_PORT = 3000

# Encodings of the protocol value domain ``Value = 0 | 1 | "?"``.
VAL0 = 0
VAL1 = 1
VALQ = 2  # the "?" value

#: Ceiling on SimConfig.witness_nodes (the witness rides extra partial
#: columns of the JAX round kernels; kept so the verdicts agree).
WITNESS_MAX_NODES = 16


def unported(what: str, item: str):
    """Raise NotImplementedError for a regime the port does not serve yet,
    naming the ROADMAP Queue A item that will bring it."""
    raise NotImplementedError(
        f"{what} is not ported to benor_tpu_torch yet (ROADMAP Queue A "
        f"item {item})")


def _unported_spec(name: str):
    unported(f"SimConfig.{name} spec strings (the fault and structure "
             "planes)", "13")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration for one simulated Ben-Or network.

    Field meanings are those of ``benor_tpu.config.SimConfig``; see that
    class for the per-field documentation.  The port serves the subset
    ``sim.check_supported`` names and raises on the rest.
    """

    # --- protocol parameters --------------------------------------------
    n_nodes: int                      # N — total nodes
    n_faulty: int                     # F — quorum = N - F
    max_rounds: int = 32

    # --- decision rule ('reference' | 'textbook') ------------------------
    rule: str = "reference"

    # --- randomness ------------------------------------------------------
    seed: int = 0
    coin_mode: str = "private"        # 'private' | 'common' | 'weak_common'
    coin_eps: float = 0.0

    # --- delivery / scheduler --------------------------------------------
    delivery: str = "all"             # 'all' | 'quorum'
    scheduler: str = "uniform"        # 'uniform' | 'biased' | 'adversarial' | 'targeted'
    adversary_strength: float = 0.0

    # --- structured delivery planes --------------------------------------
    topology: Optional[str] = None
    committee_cap: int = 0
    committee_count: int = 0
    committee_size: int = 0

    # --- compute path ----------------------------------------------------
    path: str = "auto"                # 'auto' | 'dense' | 'histogram'
    dense_path_max_n: int = 2048
    use_pallas: bool = False
    use_pallas_hist: bool = False
    use_pallas_round: bool = False

    # --- Monte-Carlo -----------------------------------------------------
    trials: int = 1                   # T — independent MC trials

    # --- dynamic fault-injection plane -----------------------------------
    drop_prob: float = 0.0
    recovery: Optional[str] = None
    partition: Optional[str] = None

    # --- fault model -----------------------------------------------------
    # 'crash' | 'byzantine' | 'equivocate' | 'crash_at_round' | 'crash_recover'
    fault_model: str = "crash"

    # --- state-machine shape ---------------------------------------------
    freeze_decided: bool = True

    # --- distribution ----------------------------------------------------
    mesh_shape: Optional[Tuple[int, int]] = None

    # --- observability ---------------------------------------------------
    poll_rounds: int = 0
    record: bool = False
    heartbeat_rounds: int = 0
    kernel_telemetry: bool = False
    witness_trials: Optional[Tuple[int, ...]] = None
    witness_nodes: int = 0

    # --- misc ------------------------------------------------------------
    backend: str = "tpu"
    oracle_order: str = "fifo"
    debug: bool = False

    def __post_init__(self) -> None:
        if self.n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        if not (0 <= self.n_faulty <= self.n_nodes):
            raise ValueError("n_faulty must be in [0, n_nodes]")
        if self.rule not in ("reference", "textbook"):
            raise ValueError(f"unknown rule: {self.rule}")
        if self.coin_mode not in ("private", "common", "weak_common"):
            raise ValueError(f"unknown coin_mode: {self.coin_mode}")
        if not (0.0 <= self.coin_eps <= 1.0):
            raise ValueError("coin_eps must be in [0, 1]")
        if self.coin_eps and self.coin_mode != "weak_common":
            raise ValueError(
                "coin_eps only applies to coin_mode='weak_common'")
        if self.delivery not in ("all", "quorum"):
            raise ValueError(f"unknown delivery: {self.delivery}")
        if self.scheduler not in ("uniform", "biased", "adversarial",
                                  "targeted"):
            raise ValueError(f"unknown scheduler: {self.scheduler}")
        if self.path not in ("auto", "dense", "histogram"):
            raise ValueError(f"unknown path: {self.path}")
        if self.fault_model not in ("crash", "byzantine", "equivocate",
                                    "crash_at_round", "crash_recover"):
            raise ValueError(f"unknown fault_model: {self.fault_model}")
        if self.recovery is not None:
            from .faults.recovery import parse_recovery
            parse_recovery(self.recovery)     # ValueError if malformed
            if self.fault_model != "crash_recover":
                raise ValueError(
                    "recovery schedules only apply to "
                    "fault_model='crash_recover' (the static fault "
                    f"models have no rejoin; got {self.fault_model!r})")
        if self.fault_model == "crash_recover" and self.backend != "tpu":
            raise ValueError(
                "fault_model='crash_recover' needs backend='tpu'")
        if not (0.0 <= self.drop_prob < 1.0):
            raise ValueError(
                f"drop_prob must be in [0, 1) (got {self.drop_prob})")
        if self.drop_prob:
            if self.delivery != "all":
                raise ValueError("drop_prob needs delivery='all'")
            if self.backend != "tpu":
                raise ValueError("drop_prob needs backend='tpu'")
            if self.fault_model == "equivocate":
                raise ValueError(
                    "drop_prob is not supported with "
                    "fault_model='equivocate'")
            if self.topology is not None or self.committee_cap:
                raise ValueError(
                    "drop_prob does not compose with topology/committee_*")
        if self.partition is not None:
            _unported_spec("partition")
        if self.fault_model == "equivocate" and self.scheduler == "biased":
            raise ValueError(
                "fault_model='equivocate' is not supported with "
                "scheduler='biased'")
        if self.delivery == "all" and self.scheduler != "uniform":
            raise ValueError(
                f"scheduler={self.scheduler!r} has no effect under "
                "delivery='all'; use delivery='quorum' or "
                "scheduler='uniform'")
        if self.topology == "complete":
            # the identity spec normalizes to None, as in the JAX package
            object.__setattr__(self, "topology", None)
        if self.topology is not None:
            _unported_spec("topology")
        if self.committee_cap < 0 or self.committee_count < 0 or \
                self.committee_size < 0:
            raise ValueError("committee knobs must be >= 0")
        if self.committee_cap:
            if not (1 <= self.committee_count <= self.committee_cap):
                raise ValueError(
                    "committee_count must be in [1, committee_cap]")
            if self.committee_cap > self.n_nodes:
                raise ValueError("committee_cap must be <= n_nodes")
            if self.committee_size < 1:
                raise ValueError(
                    "committee_size must be >= 1 when committee_cap is set")
            if self.delivery != "all":
                raise ValueError("committee delivery needs delivery='all'")
            if self.backend != "tpu":
                raise ValueError("committee delivery needs backend='tpu'")
            if self.fault_model == "equivocate":
                raise ValueError(
                    "fault_model='equivocate' is not supported with "
                    "committee delivery")
        elif self.committee_count or self.committee_size:
            raise ValueError(
                "committee_count/committee_size require committee_cap")
        if self.poll_rounds < 0:
            raise ValueError("poll_rounds must be >= 0")
        if self.heartbeat_rounds < 0:
            raise ValueError("heartbeat_rounds must be >= 0")
        if self.heartbeat_rounds and self.backend != "tpu":
            raise ValueError("heartbeat_rounds needs backend='tpu'")
        if self.poll_rounds and self.backend != "tpu":
            raise ValueError("poll_rounds needs backend='tpu'")
        if self.use_pallas_round and self.max_rounds + 1 >= (1 << 25):
            # the round counter k packs into at most 25 bit-planes
            raise ValueError(
                "use_pallas_round packs the round counter k into at most "
                "25 bit-planes (state.PACK_LAYOUT['k']); max_rounds must "
                f"be < 2**25 - 1 (got {self.max_rounds})")
        if self.witness_trials is not None:
            wt = tuple(sorted({int(t) for t in self.witness_trials}))
            if not wt:
                raise ValueError(
                    "witness_trials must name at least one trial")
            if wt[0] < 0 or wt[-1] >= self.trials:
                raise ValueError(
                    f"witness_trials must lie in [0, trials); got {wt} "
                    f"with trials={self.trials}")
            object.__setattr__(self, "witness_trials", wt)
            if not (1 <= self.witness_nodes <= self.n_nodes):
                raise ValueError(
                    "witness_nodes must be in [1, n_nodes] when "
                    "witness_trials is set")
            if self.witness_nodes > WITNESS_MAX_NODES:
                raise ValueError(
                    f"witness_nodes must be <= {WITNESS_MAX_NODES}")
            if self.backend != "tpu":
                raise ValueError("witness_trials needs backend='tpu'")
        elif self.witness_nodes:
            raise ValueError(
                "witness_nodes requires witness_trials; set both or neither")
        if self.kernel_telemetry:
            if self.backend != "tpu":
                raise ValueError("kernel_telemetry needs backend='tpu'")
            if self.mesh_shape is not None:
                raise ValueError(
                    "kernel_telemetry is single-device; drop mesh_shape "
                    "or kernel_telemetry")
        if self.record and self.backend != "tpu":
            raise ValueError("record=True needs backend='tpu'")
        if self.backend not in ("tpu", "express", "native"):
            raise ValueError(f"unknown backend: {self.backend}")
        if self.oracle_order not in ("fifo", "shuffle"):
            raise ValueError(f"unknown oracle_order: {self.oracle_order}")

    @property
    def quorum(self) -> int:
        """Messages required before a tally fires: N - F."""
        return self.n_nodes - self.n_faulty

    @property
    def witness(self) -> bool:
        """True iff the witness recorder is armed (witness_trials set)."""
        return self.witness_trials is not None

    @property
    def resolved_path(self) -> str:
        if self.path != "auto":
            return self.path
        return "dense" if self.n_nodes <= self.dense_path_max_n else "histogram"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
