"""The dynamic fault plane (port of benor_tpu/faults): crash-recovery
churn, ``SimConfig(fault_model='crash_recover', recovery='stagger:2:3:
amnesia')`` — per-node down-intervals with durable or amnesia rejoins
(``recovery.py``; the round kernels re-derive liveness from the round
bounds every round); healing partitions, ``SimConfig(partition=
'halves:<heal_round>')`` — G contiguous groups cut apart until the heal
round (``partitions.py``; group histograms, never an N x N array).
Message omission (``drop_prob``) lives in the delivery masks and tallies:
the per-edge mask on the dense path, binomial thinning of the counts on
the histogram path.  ``curves.py`` sweeps rounds-to-decide against the
omission probability and the churn depth; ``report.py`` assembles the
``faults_manifest`` document; the auditor (``audit.py``) checks the
down-interval silence and the partition-epoch tally bounds."""

from .partitions import (PartitionSpec, group_of, group_size_of,
                         parse_partition)
from .recovery import (REJOIN_MODES, RecoverySpec, crash_recover_faults,
                       parse_recovery, rejoin_mode)

__all__ = ["PartitionSpec", "group_of", "group_size_of",
           "parse_partition", "REJOIN_MODES", "RecoverySpec",
           "crash_recover_faults", "parse_recovery", "rejoin_mode"]
