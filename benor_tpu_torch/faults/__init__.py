"""The dynamic fault plane (port of benor_tpu/faults): crash-recovery
churn, ``SimConfig(fault_model='crash_recover', recovery='stagger:2:3:
amnesia')`` — per-node down-intervals with durable or amnesia rejoins
(``recovery.py``; the round kernels re-derive liveness from the round
bounds every round).  Message omission (``drop_prob``) lives in the
delivery masks and tallies; partitions are not ported yet (ROADMAP Queue
A item 13)."""

from .recovery import (REJOIN_MODES, RecoverySpec, crash_recover_faults,
                       parse_recovery, rejoin_mode)

__all__ = ["REJOIN_MODES", "RecoverySpec", "crash_recover_faults",
           "parse_recovery", "rejoin_mode"]
