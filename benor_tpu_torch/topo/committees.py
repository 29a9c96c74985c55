"""Per-round sampled committees: the second structured delivery plane
(port of benor_tpu/topo/committees.py).

Each round every node joins at most one of ``committee_count`` (g)
committees of expected size ``committee_size`` (c), and every
participating node tallies only its committee's members, itself
included.  ``committee_cap`` >= g is the static bound of the
per-committee histogram ``[T, cap, 3]``.

Membership comes from two ``fold_in`` streams with dedicated phase tags,
keyed on global (trial, node) ids: a node participates with probability
min(1, c * g / N) and, when it does, joins committee ``floor(u * g)``.
The arithmetic is float32 in the JAX package's order, so the memberships
are its memberships bit for bit.  Both protocol phases of a round tally
the same membership; non-participants sit the round out
(models/benor.py masks them out of ``active``) and their broadcasts go
silent.

Cost: one [T, N] uniform pair for membership, one ``index_add_`` of the
[T, N, 3] class indicators into the [T, cap, 3] histogram, one gather
back — O(N + T * cap) a phase, never anything N x N.  No kernel lies
here, in either package.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ
from ..ops import rng

#: Dedicated rng phase tags (ops/rng.py uses 0-3 and their +16/+32/+48
#: offsets; these stay clear of every existing stream).
PHASE_MEMBER = 8     # participation draw
PHASE_ASSIGN = 9     # committee-id draw


def membership(cfg: SimConfig, seed: int, r: int, trial_ids: torch.Tensor,
               node_ids: torch.Tensor, count, size):
    """Per-round committee membership -> (member bool [T, N], committee id
    int64 [T, N]) (committees.py:57-81).  ``count`` / ``size`` are g and
    c, ints or int32 0-dim tensors (``DynParams``); the participation
    probability ``p = min(1, (c * g) / N)`` is float32 in that order,
    either way."""
    u_p = rng.grid_uniforms(seed, r, PHASE_MEMBER, trial_ids, node_ids)
    u_g = rng.grid_uniforms(seed, r, PHASE_ASSIGN, trial_ids, node_ids)
    dev = u_p.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.int32,
                               device=dev).to(torch.float32)
    g = f32(count)
    p = torch.clamp_max((f32(size) * g) / f32(cfg.n_nodes), 1.0)
    member = u_p < p
    cid = torch.floor(u_g * g).to(torch.int32)
    return member, cid.clamp(0, cfg.committee_cap - 1).to(torch.int64)


def committee_counts(cfg: SimConfig, sent: torch.Tensor,
                     senders: torch.Tensor,
                     cid: torch.Tensor) -> torch.Tensor:
    """Per-receiver class counts over the receiver's committee -> int32
    [T, N, 3] (committees.py:84-110).

    ``senders`` masks the lanes whose broadcast lands this round (alive
    AND participating); ``cid`` is the per-lane committee id from
    ``membership``.  One ``index_add_`` over the flattened (trial,
    committee) rows builds the [T, cap, 3] histogram, then every lane
    gathers its own committee's row.  A non-participant's row is
    discarded by the round's ``active`` mask."""
    t, n = sent.shape
    cap = cfg.committee_cap
    cls = torch.stack([((sent == v) & senders).to(torch.int32)
                       for v in (VAL0, VAL1, VALQ)], dim=-1)    # [T, N, 3]
    rows = (cid + torch.arange(t, dtype=torch.int64,
                               device=cid.device)[:, None] * cap).view(-1)
    hist = torch.zeros((t * cap, 3), dtype=torch.int32, device=sent.device)
    hist.index_add_(0, rows, cls.view(-1, 3))
    return hist.index_select(0, rows).view(t, n, 3)
