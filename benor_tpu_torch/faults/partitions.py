"""Epoch-structured network partitions, the ``SimConfig.partition`` plane
(port of benor_tpu/faults/partitions.py).

A partition splits the node id range into G contiguous GROUPS; until the
spec's ``heal_round`` every message crossing a group boundary is lost
(both phases, deterministically), and from ``heal_round`` on the network
is whole again.  Under ``delivery='all'`` each receiver tallies its own
group's class histogram during the epoch ([T, G, 3] sums over the sender
groups, ``tally.partition_counts``; never an N x N array); with
``drop_prob`` the thinning applies to the group-confined counts, and on
the dense path the epoch is intersected with the per-edge omission mask
(``scheduler.omission_delivery_mask``).  A receiver whose group cannot
muster the quorum N - F stalls: the per-lane quorum gate of
models/benor.py.

Spec grammar:

    halves:<heal_round>        two contiguous halves, heal at <heal_round>
    groups:<g>:<heal_round>    g contiguous groups, heal at <heal_round>

``heal_round`` is 1-based like the message k: rounds r < heal_round run
partitioned, rounds r >= heal_round run whole.  The group of node i is
``i * g // n``, arithmetic that works on ints and integer tensors alike.
The grammar and its error messages are the JAX package's; this module
imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """One parsed partition: G contiguous groups until ``heal_round``."""

    groups: int      # number of contiguous groups (>= 2)
    heal_round: int  # first WHOLE round (1-based); rounds before it split
    spec: str        # the original spec string

    def validate(self, n_nodes: int) -> None:
        if self.groups < 2:
            raise ValueError(
                f"partition spec {self.spec!r}: needs >= 2 groups "
                "(1 group is the whole network — drop the spec instead)")
        if self.groups > n_nodes:
            raise ValueError(
                f"partition spec {self.spec!r}: {self.groups} groups "
                f"cannot all be non-empty at n_nodes={n_nodes}")
        if self.heal_round < 1:
            raise ValueError(
                f"partition spec {self.spec!r}: heal_round must be >= 1 "
                "(round indices are 1-based; heal_round=1 never "
                "partitions anything — drop the spec instead)")

    def group_sizes(self, n_nodes: int) -> List[int]:
        """Per-group node counts under the contiguous ``i * g // n``
        assignment."""
        g = self.groups
        bounds = [_ceil_div(k * n_nodes, g) for k in range(g + 1)]
        return [bounds[k + 1] - bounds[k] for k in range(g)]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def parse_partition(spec: Optional[str]) -> Optional[PartitionSpec]:
    """Spec string -> PartitionSpec; None passes through (no partition).
    Raises ValueError on a malformed spec."""
    if spec is None:
        return None
    parts = str(spec).split(":")
    kind = parts[0]
    if kind == "halves":
        if len(parts) != 2:
            raise ValueError(
                f"partition spec {spec!r}: expected 'halves:<heal_round>'")
        groups, heal = 2, parts[1]
    elif kind == "groups":
        if len(parts) != 3:
            raise ValueError(
                f"partition spec {spec!r}: expected "
                "'groups:<g>:<heal_round>'")
        groups, heal = parts[1], parts[2]
    else:
        raise ValueError(
            f"unknown partition spec {spec!r}: grammar is "
            "'halves:<heal_round>' or 'groups:<g>:<heal_round>'")
    try:
        groups, heal = int(groups), int(heal)
    except ValueError:
        raise ValueError(
            f"partition spec {spec!r}: <g> and <heal_round> must be "
            "integers") from None
    out = PartitionSpec(groups=groups, heal_round=heal, spec=str(spec))
    if out.groups < 2 or out.heal_round < 1:
        out.validate(n_nodes=out.groups)     # raise the specific message
    return out


def group_of(node_ids, n_nodes: int, groups: int):
    """Group index of each node id under the contiguous assignment,
    ``i * g // n``: Python ints, numpy arrays and integer tensors alike."""
    return node_ids * groups // n_nodes


def group_size_of(node_id: int, n_nodes: int, spec: PartitionSpec) -> int:
    """Size of the group holding ``node_id``: the ceiling on any tally
    witnessed inside the partition epoch."""
    return spec.group_sizes(n_nodes)[int(group_of(node_id, n_nodes,
                                                  spec.groups))]
