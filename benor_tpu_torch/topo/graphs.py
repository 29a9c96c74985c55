"""Topology specs: structured sparse delivery graphs (port of
benor_tpu/topo/graphs.py).

A topology names, per receiver, the d senders it tallies — carried as
closed-form index arithmetic (ring / torus / expander) or one static
``[N, d]`` neighbour-index table (random-regular), never a dense N x N
adjacency tensor, so 1M nodes cost O(N * d) memory and work
(``deliver.py``).

Spec grammar (``SimConfig.topology``) — one string, colon-separated:

  ``complete``                the identity spec: all-to-all delivery.
                              Normalised to ``topology=None`` by
                              SimConfig, so selecting it is the run
                              without a topology, bit for bit.
  ``ring:<d>``                circulant ring, EVEN degree d: receiver i
                              tallies i +- 1 .. i +- d/2 (mod N).
  ``torus2d:<rows>x<cols>``   4-neighbour 2D torus (N == rows * cols,
                              both >= 3): up/down/left/right with wrap.
  ``expander:<d>``            circulant expander, EVEN degree d:
                              offsets +- 2^j for j < d/2 — O(log N)
                              diameter with closed-form indices.
  ``random_regular:<d>[:seed]``  seeded random graph with in-degree
                              exactly d (each receiver tallies d
                              distinct uniform senders).  The ``[N, d]``
                              table is built on the host once per
                              (spec, N).

Every receiver additionally tallies ITSELF (broadcasts include self), so
the tallied neighbourhood has d + 1 members and the quorum rule reads
"count > F within the d + 1 neighbourhood".

The grammar, the validation and every error message are the JAX
package's, word for word.  This module imports the standard library only
(numpy inside the table builder).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

#: The spec kinds ``parse_topology`` accepts ('complete' normalizes to
#: None at the SimConfig boundary and never reaches a TopologySpec).
KINDS = ("ring", "torus2d", "expander", "random_regular")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """One parsed topology spec — hashable and cheap to re-derive from
    the string."""

    kind: str                 # one of KINDS
    degree: int               # d — tallied neighbors per receiver
    rows: int = 0             # torus2d only
    cols: int = 0             # torus2d only
    graph_seed: int = 0       # random_regular only

    def validate(self, n_nodes: int) -> None:
        """Raise ValueError unless this spec is realizable at N nodes."""
        n = n_nodes
        if self.kind in ("ring", "expander"):
            if self.degree % 2 or self.degree < 2:
                raise ValueError(
                    f"{self.kind} degree must be even and >= 2 "
                    f"(offsets come in +- pairs); got {self.degree}")
            if self.degree > n - 1:
                raise ValueError(
                    f"{self.kind}:{self.degree} needs at least "
                    f"degree + 1 = {self.degree + 1} nodes (got {n})")
            if self.kind == "expander" and (1 << (self.degree // 2 - 1)) \
                    >= n:
                raise ValueError(
                    f"expander:{self.degree} folds offsets +-2^j up to "
                    f"j={self.degree // 2 - 1}, which wraps past N={n}; "
                    "lower the degree or grow the network")
            # circulant offsets must name d DISTINCT non-self senders mod
            # N — an aliasing pair (e.g. +-N/2, or two powers congruent
            # mod N) would silently DOUBLE-COUNT that sender's vote in
            # every tally, a forged-evidence generator no audit could
            # distinguish from a real message
            offs = circulant_offsets(self)
            residues = {o % n for o in offs}
            if 0 in residues or len(residues) != len(offs):
                raise ValueError(
                    f"{self.kind}:{self.degree} offsets alias modulo "
                    f"N={n} (the +-offset pairs do not name "
                    f"{self.degree} distinct non-self senders); lower "
                    "the degree or grow the network")
        elif self.kind == "torus2d":
            if self.rows < 3 or self.cols < 3:
                raise ValueError(
                    "torus2d needs rows >= 3 and cols >= 3 (smaller "
                    "wraps alias two neighbors onto one sender); got "
                    f"{self.rows}x{self.cols}")
            if self.rows * self.cols != n:
                raise ValueError(
                    f"torus2d:{self.rows}x{self.cols} covers "
                    f"{self.rows * self.cols} nodes but the network has "
                    f"{n}")
        elif self.kind == "random_regular":
            # d <= N/2 keeps the table builder's collision re-roll
            # geometric (success prob >= ~1/2 per pass); past N/2 the
            # repair degenerates toward coupon-collecting the last few
            # free ids — an unbounded stall in the table builder.  A
            # random graph that dense approximates the complete graph
            # anyway.
            if not (1 <= self.degree <= n // 2):
                raise ValueError(
                    f"random_regular degree must be in [1, N//2] (the "
                    f"seeded table repair is only geometric below "
                    f"half-density; denser graphs ~ 'complete'); got "
                    f"{self.degree} at N={n}")
        else:
            raise ValueError(f"unknown topology kind: {self.kind!r}")

    def diameter(self, n_nodes: int) -> int:
        """Graph diameter in hops — EXACT for ring and torus2d
        (consecutive-offset circulants and the 4-neighbor torus have
        closed forms), a documented UPPER-BOUND ESTIMATE for expander
        (largest-offset greedy + one adjust step per remaining power)
        and random_regular (the classic log_d N concentration bound).
        Closed-form on purpose: no numpy, no BFS."""
        n = n_nodes
        if self.kind == "ring":
            return max(1, math.ceil((n // 2) / (self.degree // 2)))
        if self.kind == "torus2d":
            return self.rows // 2 + self.cols // 2
        if self.kind == "expander":
            k = self.degree // 2
            return max(1, math.ceil((n // 2) / (1 << (k - 1))) + (k - 1))
        # random_regular: diameter concentrates at log_d N for d >= 2
        if self.degree < 2:
            return max(1, n - 1)
        return max(1, math.ceil(math.log(max(n, 2))
                                / math.log(self.degree)))

    def diameter_exact(self) -> bool:
        """True iff ``diameter`` is the exact graph diameter (ring,
        torus2d) rather than an upper-bound estimate."""
        return self.kind in ("ring", "torus2d")

    def metadata(self, n_nodes: int) -> dict:
        """The spec's science-row metadata: degree / diameter (+ whether
        the diameter is exact) — the fields the rounds-vs-degree curve
        rows carry and tools/check_metrics_schema.py recomputes."""
        return {"degree": int(self.degree),
                "diameter": int(self.diameter(n_nodes)),
                "diameter_exact": bool(self.diameter_exact())}

    def spec_string(self) -> str:
        """The canonical string form (round-trips through
        ``parse_topology``)."""
        if self.kind == "torus2d":
            return f"torus2d:{self.rows}x{self.cols}"
        if self.kind == "random_regular":
            return f"random_regular:{self.degree}:{self.graph_seed}"
        return f"{self.kind}:{self.degree}"


def parse_topology(spec: Optional[str]) -> Optional[TopologySpec]:
    """Spec string -> TopologySpec (None / 'complete' -> None).

    Raises ValueError on anything malformed; SimConfig surfaces these
    at construction."""
    if spec is None or spec == "complete":
        return None
    if not isinstance(spec, str):
        raise ValueError(
            f"topology must be a spec string (see benor_tpu/topo/"
            f"graphs.py); got {type(spec).__name__}")
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind in ("ring", "expander"):
            if len(parts) != 2:
                raise ValueError
            return TopologySpec(kind=kind, degree=int(parts[1]))
        if kind == "torus2d":
            if len(parts) != 2:
                raise ValueError
            rows, cols = (int(x) for x in parts[1].split("x"))
            return TopologySpec(kind=kind, degree=4, rows=rows, cols=cols)
        if kind == "random_regular":
            if len(parts) not in (2, 3):
                raise ValueError
            seed = int(parts[2]) if len(parts) == 3 else 0
            return TopologySpec(kind=kind, degree=int(parts[1]),
                                graph_seed=seed)
    except ValueError:
        # every ValueError inside the try is a parse-shape failure (bad
        # arity, non-integer field) — always answer with the grammar,
        # never a raw int()/unpack message
        raise ValueError(
            f"malformed topology spec {spec!r}: expected "
            "'complete' | 'ring:<d>' | 'torus2d:<rows>x<cols>' | "
            "'expander:<d>' | 'random_regular:<d>[:seed]'") from None
    raise ValueError(
        f"unknown topology kind {kind!r} in {spec!r} "
        f"(known: complete, {', '.join(KINDS)})")


def circulant_offsets(spec: TopologySpec) -> list:
    """The signed neighbor offsets of a circulant spec (ring/expander) —
    the closed-form index arithmetic ``deliver.py`` applies to global
    receiver ids, O(d) integers instead of any adjacency tensor."""
    if spec.kind == "ring":
        half = [j for j in range(1, spec.degree // 2 + 1)]
    elif spec.kind == "expander":
        half = [1 << j for j in range(spec.degree // 2)]
    else:
        raise ValueError(f"{spec.kind} is not a circulant spec")
    return [o for j in half for o in (j, -j)]


def build_neighbor_table(spec: TopologySpec, n_nodes: int):
    """Static int32 ``[N, d]`` neighbor-index table: row i lists the d
    global sender ids receiver i tallies (self excluded — the delivery
    layer adds the self edge).  Closed-form specs derive rows
    arithmetically; random_regular draws each row as d distinct uniform
    senders from ``np.random.default_rng(graph_seed)`` with the same
    repair loop as the JAX package, so the table equals its table
    element for element — a pure function of (spec, N), built on the
    host once per (spec, N) and cached by ``deliver.network_neighbors``."""
    import numpy as np

    spec.validate(n_nodes)
    n, d = n_nodes, spec.degree
    # int32 throughout, as in the JAX package (ids stay < 2^31 by the
    # config's own bounds); the device gather widens it to int64 once
    ids = np.arange(n, dtype=np.int32)
    if spec.kind in ("ring", "expander"):
        k = d // 2
        half = (np.arange(1, k + 1, dtype=np.int32) if spec.kind == "ring"
                else (np.int32(1) << np.arange(k, dtype=np.int32)))
        offs = np.stack([half, -half], axis=1).reshape(-1)
        return ((ids[:, None] + offs[None, :]) % n).astype(np.int32)
    if spec.kind == "torus2d":
        rows, cols = spec.rows, spec.cols
        r, c = ids // cols, ids % cols
        nb = np.stack([
            r * cols + (c + 1) % cols,
            r * cols + (c - 1) % cols,
            ((r + 1) % rows) * cols + c,
            ((r - 1) % rows) * cols + c,
        ], axis=1)
        return nb.astype(np.int32)
    # random_regular: iid draws per slot, then vectorized repair of
    # self-loops and within-row duplicates (re-roll the offending slots
    # until every row holds d distinct non-self senders; d << N makes
    # the collision mass shrink geometrically, so the loop terminates
    # in a handful of passes)
    # benorlint: allow-host-rng — seeded STATIC graph construction on the
    # host, once a config (a pure function of (graph_seed, N), moved to
    # the device as the neighbour table); protocol draws all use
    # ops/rng.py
    gen = np.random.default_rng(spec.graph_seed)
    tbl = gen.integers(0, n, size=(n, d), dtype=np.int32)
    for _ in range(10_000):
        bad = tbl == ids[:, None]
        srt = np.sort(tbl, axis=1)
        dup_sorted = np.zeros_like(bad)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        # map the sorted-duplicate flags back onto the unsorted slots
        order = np.argsort(tbl, axis=1, kind="stable")
        dup = np.zeros_like(bad)
        np.put_along_axis(dup, order, dup_sorted, axis=1)
        bad |= dup
        n_bad = int(bad.sum())
        if not n_bad:
            break
        tbl[bad] = gen.integers(0, n, size=n_bad, dtype=np.int32)
    else:  # pragma: no cover — d <= N-1 guarantees convergence
        raise RuntimeError("random_regular table repair did not converge")
    return tbl.astype(np.int32)
