"""Neighbourhood tallies: the adjacency-structured delivery plane (port of
benor_tpu/topo/deliver.py).

Each receiver tallies exactly its topology neighbourhood — the d senders
its ``TopologySpec`` names plus ITSELF (broadcasts include self) — through
one ``[T, N, d]`` gather per phase, never an N x N anything: the
neighbour ids are closed-form arithmetic on global receiver ids (ring /
torus / expander) or rows of a static ``[N, d]`` table (random_regular).
The whole network's ``[N, d]`` index is built once per (spec, N, device)
and kept, int32, in a small cache; the gather takes it flattened to
``[N * d]`` along the node axis (``index_select``), so the index is never
widened to ``[T, N, d]``.

The tallied multiset has d + 1 members, so the decide rule ``count(v) >
F`` (models/benor.py, unchanged) reads "count > F within the d + 1
neighbourhood".

Fault models: crash / crash_at_round / crash_recover ride the ``alive``
mask (a dead neighbour's edge goes silent); ``byzantine`` rides the
flipped ``sent`` values; ``equivocate`` draws an independent fair bit per
delivered (receiver, equivocator) edge, the equivocator's self edge
included, from ``rng.edge_uniforms`` on the dense path's stream family
(phase + 32), keyed on (trial, receiver, neighbour slot) with slot d the
self edge.  Under a partition epoch (r < heal_round) a neighbour edge
that crosses a group boundary goes silent.

No kernel lies here, in either package: structured delivery requires
``delivery='all'``, which every fused-kernel gate rejects.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ
from ..faults.partitions import group_of, parse_partition
from ..ops import rng
from .graphs import build_neighbor_table, circulant_offsets, parse_topology

def neighbor_ids(cfg: SimConfig, node_ids: torch.Tensor) -> torch.Tensor:
    """Global sender ids each receiver tallies -> int64 [N_recv, d].

    ``node_ids`` (int64 [N_recv]) are GLOBAL receiver ids.  Circulant
    specs (ring / expander) are index arithmetic mod N; the torus is
    divmod arithmetic; random_regular gathers rows of its table."""
    spec = parse_topology(cfg.topology)
    n = cfg.n_nodes
    ids = node_ids.to(torch.int64)
    if spec.kind == "random_regular":
        return network_neighbors(cfg.topology, n, ids.device).index_select(
            0, ids).to(torch.int64)
    if spec.kind in ("ring", "expander"):
        offs = torch.tensor(circulant_offsets(spec), dtype=torch.int64,
                            device=ids.device)
        return (ids[:, None] + offs[None, :]) % n
    if spec.kind == "torus2d":
        rows, cols = spec.rows, spec.cols
        r, c = ids // cols, ids % cols
        return torch.stack([
            r * cols + (c + 1) % cols,
            r * cols + (c - 1) % cols,
            ((r + 1) % rows) * cols + c,
            ((r - 1) % rows) * cols + c,
        ], dim=1)
    raise ValueError(f"unknown topology kind {spec.kind!r}")


@functools.lru_cache(maxsize=4)
def network_neighbors(topology: str, n: int,
                      device: torch.device) -> torch.Tensor:
    """The whole network's neighbour ids -> int32 [N, d] on ``device``,
    built once per (spec, N, device): the random_regular table's host
    build (numpy, a repair loop) runs once, and a run's rounds share the
    index."""
    spec = parse_topology(topology)
    if spec.kind == "random_regular":
        table = torch.from_numpy(build_neighbor_table(spec, n))
    else:
        table = neighbor_ids(SimConfig(n_nodes=n, n_faulty=0,
                                       topology=topology),
                             torch.arange(n, dtype=torch.int64,
                                          device=device))
    return table.to(device=device, dtype=torch.int32)


def _gather(x: torch.Tensor, flat: torch.Tensor, d: int) -> torch.Tensor:
    """x [T, N_send] at the flattened neighbour ids [N_recv * d] ->
    [T, N_recv, d]."""
    return x.index_select(1, flat).view(x.shape[0], -1, d)


def neighborhood_counts(cfg: SimConfig, seed: int, r: int, phase: int,
                        sent: torch.Tensor, alive: torch.Tensor,
                        equiv: Optional[torch.Tensor] = None,
                        trial_ids: Optional[torch.Tensor] = None,
                        node_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Per-receiver class counts over the receiver's d + 1 neighbourhood
    -> int32 [T, N, 3] (deliver.py:86-158).

    The topology counterpart of ``tally.receiver_counts``, which dispatches
    here when ``cfg.topology`` is set.  ``sent`` / ``alive`` / ``equiv``
    are [T, N] over the whole network; ``trial_ids`` / ``node_ids`` are the
    global ids that key the equivocator edge bits (default 0..T-1 /
    0..N-1).  The self edge uses the receiver's own ``sent`` and
    ``alive``."""
    t, n = sent.shape
    dev = sent.device
    if trial_ids is None:
        trial_ids = rng.ids(t, device=dev)
    if node_ids is None:
        node_ids = rng.ids(n, device=dev)
        nbr = network_neighbors(cfg.topology, cfg.n_nodes, dev)  # [N, d]
    else:
        nbr = neighbor_ids(cfg, node_ids)
    d = nbr.shape[1]
    flat = nbr.reshape(-1)
    sv = _gather(sent, flat, d)                             # [T, N, d]
    av = _gather(alive, flat, d)
    part = parse_partition(cfg.partition)
    if part is not None and r < part.heal_round:
        # inside the epoch a neighbour edge across a group boundary goes
        # silent; the self edge is always same-group
        g_recv = group_of(node_ids.to(torch.int64), cfg.n_nodes,
                          part.groups)
        same = (group_of(nbr.to(torch.int64), cfg.n_nodes, part.groups)
                == g_recv[:, None])
        av = av & same[None, :, :]
    if equiv is not None:
        ev = _gather(equiv, flat, d)
        honest = av & ~ev
        self_honest = alive & ~equiv
    else:
        honest = av
        self_honest = alive

    def class_count(v):
        neigh = ((sv == v) & honest).sum(-1, dtype=torch.int32)
        return neigh + ((sent == v) & self_honest).to(torch.int32)

    counts = torch.stack([class_count(v) for v in (VAL0, VAL1, VALQ)],
                         dim=-1)                            # [T, N, 3]
    if equiv is None:
        return counts
    # one fair bit per (trial, receiver, neighbour slot), slot d the self
    # edge, on the dense path's stream family (phase + 32)
    bits = rng.edge_uniforms(seed, r, phase + 32, trial_ids, node_ids,
                             rng.ids(d + 1, device=dev)) < 0.5
    deliv = torch.cat([av & ev, (alive & equiv)[:, :, None]], dim=-1)
    c1 = (deliv & bits).sum(-1, dtype=torch.int32)
    c0 = deliv.sum(-1, dtype=torch.int32) - c1
    return counts + torch.stack([c0, c1, torch.zeros_like(c0)], dim=-1)
