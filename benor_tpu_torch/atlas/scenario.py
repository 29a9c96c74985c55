"""Declarative scenario axes: the atlas search grammar over the swept knobs
(port of benor_tpu/atlas/scenario.py).

A :class:`ScenarioAxis` names ONE existing swept knob, a closed value
range and a pinned refinement tolerance; ``apply(cfg, value)`` realizes
a probe as a plain ``SimConfig`` — the axis never invents delivery
semantics, it only drives the knobs the fault, topology and committee
planes already validate.  The spec grammar is one colon-separated string:

    ``<name>:<lo>:<hi>[:<tol>]``

with ``<name>`` one of:

  ``drop_prob``        per-edge omission probability (a DynParams axis:
                       a whole generation is ONE dynamic bucket)
  ``f``                protocol fault parameter F (a DynParams axis: one
                       dynamic bucket per generation on delivery='all')
  ``heal_round``       ``partition='halves:<v>'`` heal epoch (static
                       spec: one bucket per distinct probe value)
  ``recovery_down``    ``recovery='at:2:<v>'`` down-interval length
                       under ``fault_model='crash_recover'`` (static)
  ``topology_degree``  ``topology='ring:<v>'`` circulant degree (even;
                       static — tol snaps to 2)
  ``committee_size``   per-round sampled committee size (a DynParams axis
                       when the committee plane is armed via
                       ``committee_cap`` on the base config)

Integer axes bisect on the integer lattice (tol >= 1); continuous axes
bisect to the pinned tolerance.  ``faults`` names the fault policy the
evaluator builds per probe: ``'none'`` (all lanes alive — the omission
/ partition regimes, where quorum slack is the physics) or
``'default'`` (run_point's first-F-faulty policy, schedule-aware under
crash_recover).  The grammar and its messages are the JAX package's;
this module imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

#: knob name -> (integer lattice?, default tolerance, snap step,
#: fault policy).  The single registry the parser, the evaluator and
#: the manifest checker share.
AXIS_KINDS = {
    "drop_prob": {"integer": False, "tol": 0.02, "step": 0.0,
                  "faults": "none"},
    "f": {"integer": True, "tol": 1.0, "step": 1.0, "faults": "default"},
    "heal_round": {"integer": True, "tol": 1.0, "step": 1.0,
                   "faults": "none"},
    "recovery_down": {"integer": True, "tol": 1.0, "step": 1.0,
                      "faults": "default"},
    "topology_degree": {"integer": True, "tol": 2.0, "step": 2.0,
                        "faults": "default"},
    "committee_size": {"integer": True, "tol": 1.0, "step": 1.0,
                       "faults": "default"},
}


@dataclasses.dataclass(frozen=True)
class ScenarioAxis:
    """One search dimension: a knob, a range, a pinned tolerance."""

    name: str
    lo: float
    hi: float
    tol: float
    integer: bool
    step: float     # integer-lattice stride (2 for even-degree rings)
    faults: str     # 'none' | 'default' — the evaluator's fault policy
    spec: str       # the grammar string this axis parsed from

    def snap(self, value: float) -> float:
        """Clamp + project a raw value onto the axis lattice."""
        v = min(max(float(value), self.lo), self.hi)
        if self.step:
            v = self.step * round(v / self.step)
            v = min(max(v, self.lo), self.hi)
        return float(v)

    def grid(self, coarse: int) -> List[float]:
        """``coarse + 1`` evenly spaced snapped values, lo..hi inclusive,
        deduplicated in order (integer lattices collapse close points)."""
        if coarse < 1:
            raise ValueError("coarse grid needs >= 1 interval")
        raw = [self.lo + (self.hi - self.lo) * i / coarse
               for i in range(coarse + 1)]
        out: List[float] = []
        for v in (self.snap(r) for r in raw):
            if not out or v != out[-1]:
                out.append(v)
        return out

    def converged(self, lo: float, hi: float) -> bool:
        """True when a bracket is at the pinned tolerance (a tiny eps
        absorbs float drift from repeated midpoint halving)."""
        return (hi - lo) <= self.tol * (1 + 1e-9)

    def midpoint(self, lo: float, hi: float) -> Optional[float]:
        """The snapped bisection probe inside (lo, hi), or None when the
        bracket is converged / the lattice has no interior point."""
        if self.converged(lo, hi):
            return None
        mid = self.snap((lo + hi) / 2.0)
        if mid <= lo or mid >= hi:
            return None
        return mid

    def apply(self, cfg, value: float):
        """Realize one probe: base config + this axis at ``value``.
        Raises the underlying SimConfig validation error verbatim on an
        incoherent combination (fail-loudly, the spec-grammar contract).
        """
        v = self.snap(value)
        i = int(round(v))
        if self.name == "drop_prob":
            return cfg.replace(drop_prob=v)
        if self.name == "f":
            return cfg.replace(n_faulty=i)
        if self.name == "heal_round":
            return cfg.replace(partition=f"halves:{i}")
        if self.name == "recovery_down":
            return cfg.replace(fault_model="crash_recover",
                               recovery=f"at:2:{i}")
        if self.name == "topology_degree":
            return cfg.replace(topology=f"ring:{i}")
        if self.name == "committee_size":
            if not cfg.committee_cap:
                raise ValueError(
                    "committee_size axis needs a base config with the "
                    "committee plane armed (committee_cap > 0)")
            return cfg.replace(committee_size=i)
        raise ValueError(f"unknown scenario axis {self.name!r}")

    def to_dict(self) -> dict:
        return {"name": self.name, "lo": self.lo, "hi": self.hi,
                "tol": self.tol, "integer": self.integer,
                "spec": self.spec}


def parse_axis(spec: str) -> ScenarioAxis:
    """``'<name>:<lo>:<hi>[:<tol>]'`` -> a validated ScenarioAxis."""
    parts = str(spec).split(":")
    if len(parts) not in (3, 4):
        raise ValueError(
            f"scenario axis spec {spec!r}: grammar is "
            f"'<name>:<lo>:<hi>[:<tol>]' with <name> one of "
            f"{sorted(AXIS_KINDS)}")
    name = parts[0]
    if name not in AXIS_KINDS:
        raise ValueError(
            f"unknown scenario axis {name!r}; known axes: "
            f"{sorted(AXIS_KINDS)}")
    kind = AXIS_KINDS[name]
    try:
        lo, hi = float(parts[1]), float(parts[2])
        tol = float(parts[3]) if len(parts) == 4 else float(kind["tol"])
    except ValueError:
        raise ValueError(
            f"scenario axis spec {spec!r}: <lo>/<hi>/<tol> must be "
            f"numbers") from None
    if not lo < hi:
        raise ValueError(f"scenario axis spec {spec!r}: need lo < hi")
    if tol <= 0:
        raise ValueError(f"scenario axis spec {spec!r}: tol must be > 0")
    if kind["integer"]:
        if lo != int(lo) or hi != int(hi):
            raise ValueError(
                f"scenario axis spec {spec!r}: {name} is an integer "
                f"axis; lo/hi must be integers")
        tol = max(tol, float(kind["tol"]))
    return ScenarioAxis(name=name, lo=lo, hi=hi, tol=tol,
                        integer=bool(kind["integer"]),
                        step=float(kind["step"]),
                        faults=str(kind["faults"]), spec=str(spec))
