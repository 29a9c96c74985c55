"""Crash-recovery schedules for ``fault_model='crash_recover'`` (port of
benor_tpu/faults/recovery.py).

Lane i is DOWN for rounds ``crash_round[i] <= r < recover_round[i]``: it
neither sends nor tallies, its (x, decided, k) freeze and it leaves the
alive count.  ``recover_round <= 0`` means it never rejoins: it latches
``killed``, exactly the ``crash_at_round`` semantics.  At ``r ==
recover_round`` it is back: under the ``durable`` rejoin mode with the x
it crashed with, under ``amnesia`` an UNDECIDED rejoiner restarts from
"?" (decisions are always durable).

The schedule is a spec string (``SimConfig.recovery``):

    at:<crash>:<down>[:amnesia|durable]
        every faulty lane crashes at round <crash> and rejoins <down>
        rounds later (<down> = 0: never).
    stagger:<crash>:<down>[:amnesia|durable]
        the j-th faulty lane (j = 0..F-1 in id order) crashes at round
        <crash> + j and rejoins <down> rounds later.

Parsing is stdlib-only; the FaultSpec builder imports torch lazily.  The
grammar, the error messages and the realized rounds are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: The two rejoin modes.  'durable': state survives the crash; 'amnesia':
#: the volatile x restarts at "?" (decisions are durable either way).
REJOIN_MODES = ("durable", "amnesia")


@dataclasses.dataclass(frozen=True)
class RecoverySpec:
    """One parsed recovery schedule."""

    kind: str       # 'at' | 'stagger'
    crash: int      # first crash round (1-based, like message k)
    down: int       # rounds down before rejoin; 0 = never rejoins
    rejoin: str     # 'durable' | 'amnesia'
    spec: str       # the original spec string

    def validate(self) -> None:
        if self.crash < 1:
            raise ValueError(
                f"recovery spec {self.spec!r}: crash round must be >= 1 "
                "(round indices are 1-based, like the message k)")
        if self.down < 0:
            raise ValueError(
                f"recovery spec {self.spec!r}: down length must be >= 0 "
                "(0 = the lane never rejoins)")

    def rounds(self, n_faulty: int) -> Tuple[list, list]:
        """(crash_rounds, recover_rounds) for the F faulty lanes in id
        order, as plain ints."""
        if self.kind == "at":
            crash = [self.crash] * n_faulty
        else:                                   # stagger
            crash = [self.crash + j for j in range(n_faulty)]
        recover = [(c + self.down) if self.down > 0 else 0 for c in crash]
        return crash, recover


def parse_recovery(spec: Optional[str]) -> Optional[RecoverySpec]:
    """Spec string -> RecoverySpec; None passes through (no schedule).
    A malformed spec raises ValueError."""
    if spec is None:
        return None
    parts = str(spec).split(":")
    kind = parts[0]
    if kind not in ("at", "stagger"):
        raise ValueError(
            f"unknown recovery spec {spec!r}: grammar is "
            "'at:<crash>:<down>[:amnesia|durable]' or "
            "'stagger:<crash>:<down>[:amnesia|durable]'")
    rejoin = "durable"
    body = parts[1:]
    if body and body[-1] in REJOIN_MODES:
        rejoin = body[-1]
        body = body[:-1]
    if len(body) != 2:
        raise ValueError(
            f"recovery spec {spec!r}: expected "
            f"'{kind}:<crash>:<down>[:amnesia|durable]'")
    try:
        crash, down = int(body[0]), int(body[1])
    except ValueError:
        raise ValueError(
            f"recovery spec {spec!r}: <crash> and <down> must be "
            "integers") from None
    out = RecoverySpec(kind=kind, crash=crash, down=down, rejoin=rejoin,
                       spec=str(spec))
    out.validate()
    return out


def rejoin_mode(spec: Optional[str]) -> str:
    """The rejoin mode a config's recovery spec declares ('durable' when no
    spec is set): the switch the amnesia reset keys on."""
    parsed = parse_recovery(spec)
    return parsed.rejoin if parsed is not None else "durable"


def crash_recover_faults(cfg, device=None):
    """The default fault policy for ``fault_model='crash_recover'``: the
    first F lanes faulty, their down-intervals realized from
    ``cfg.recovery`` -> the port's FaultSpec on ``device``."""
    from ..state import FaultSpec

    spec = parse_recovery(cfg.recovery)
    if spec is None:
        raise ValueError(
            "fault_model='crash_recover' needs a recovery schedule: set "
            "SimConfig(recovery='at:<crash>:<down>[:amnesia|durable]') "
            "or pass an explicit FaultSpec with recover_round")
    f = cfg.n_faulty
    crash, recover = spec.rounds(f)
    zeros = [0] * (cfg.n_nodes - f)
    return FaultSpec.first_f(cfg, crash_rounds=crash + zeros,
                             recover_rounds=recover + zeros, device=device)
