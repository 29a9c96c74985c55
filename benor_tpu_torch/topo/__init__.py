"""Adjacency- and committee-structured delivery (port of benor_tpu/topo).

``SimConfig(topology=...)`` replaces the implicit complete graph with a
declarative sparse spec (ring / 2D torus / expander / random-regular —
closed-form neighbour indices or one static [N, d] table, never a dense
N x N adjacency tensor), and ``SimConfig(committee_cap/count/size)``
replaces it with per-round sampled committees.  Both planes run in the
unfused round (models/benor.py), with the quorum rule read against the
neighbourhood or committee.

Modules: ``graphs`` (the spec grammar, metadata and tables), ``deliver``
(the O(N * d) gather tally), ``committees`` (membership and committee
histograms).
"""

from .graphs import (KINDS, TopologySpec, build_neighbor_table,
                     circulant_offsets, parse_topology)

__all__ = ["KINDS", "TopologySpec", "build_neighbor_table",
           "circulant_offsets", "parse_topology"]
