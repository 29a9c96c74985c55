"""The seeded message scheduler's delivery masks
(port of benor_tpu/ops/scheduler.py; the dense path only, N x N masks):
the quorum schedulers' arrival masks and the omission mask of
``delivery='all'`` with ``drop_prob``, cut by a partition epoch where one
is armed.

    uniform  every (receiver, sender) edge draws an iid delay; the N - F
             smallest delays per receiver define the tallied multiset.
    biased   uniform delays plus ``adversary_strength`` on the edges whose
             message carries the value the receiver's parity class is being
             starved of (even receivers: 1-carrying, odd receivers:
             0-carrying).

Delays key on global (trial, receiver, sender) ids (``rng.edge_uniforms``),
so the masks equal the JAX package's bit for bit.  That includes rows with
tied delays: a uniform has 23 random bits, so equal delays are common at
N = 2048, and ``jax.lax.top_k`` puts the lower sender index first among
equals.  ``_top_m_mask`` keeps that rule with a stable ascending sort, on
the CPU and on the card alike (``torch.topk`` promises no order).
"""

from __future__ import annotations

import torch

from ..config import SimConfig, VAL0, VAL1, VALQ
from ..faults.partitions import group_of
from . import rng


def full_delivery_mask(alive: torch.Tensor) -> torch.Tensor:
    """delivery == 'all': every live sender reaches every receiver.
    alive: bool [T, N] -> mask bool [T, N_recv, N_send] (an expanded view;
    the broadcast includes self)."""
    t, n = alive.shape
    return alive[:, None, :].expand(t, n, n)


def default_ids(trial_ids, recv_ids, t, n, device):
    """The global trial and receiver ids, 0..T-1 / 0..N-1 where not
    given."""
    if trial_ids is None:
        trial_ids = rng.ids(t, device=device)
    if recv_ids is None:
        recv_ids = rng.ids(n, device=device)
    return trial_ids, recv_ids


def quorum_delivery_mask(cfg: SimConfig, seed: int, r: int, phase: int,
                         sent: torch.Tensor, alive: torch.Tensor,
                         trial_ids=None, recv_ids=None) -> torch.Tensor:
    """Per-receiver top-(N - F) arrival mask for the 'uniform' and 'biased'
    schedulers -> bool [T, N_recv, N_send]: for each receiver the
    min(N - F, #alive) live senders with the smallest delays.

    sent: int8 [T, N_send] sender values this phase (read only by the biased
    scheduler); alive: bool [T, N_send]; ``trial_ids`` / ``recv_ids``: the
    global ids of the trials and receivers (default 0..T-1 / 0..N-1)."""
    t, n = alive.shape
    trial_ids, recv_ids = default_ids(trial_ids, recv_ids, t, n,
                                      alive.device)
    delays = rng.edge_uniforms(seed, r, phase, trial_ids, recv_ids,
                               rng.ids(n, device=alive.device))

    if cfg.scheduler == "biased" and cfg.adversary_strength != 0.0:
        # Split-bias: even receivers' 1-carrying edges and odd receivers'
        # 0-carrying edges are delayed.  delays + strength * {0, 1} in f32,
        # written as a select (adding 0.0 moves no bit of a delay >= 0).
        even_recv = (recv_ids % 2 == 0)[None, :, None]
        starved = torch.where(even_recv, (sent == VAL1)[:, None, :],
                              (sent == VAL0)[:, None, :])
        strength = torch.tensor(cfg.adversary_strength, dtype=torch.float32,
                                device=delays.device)
        delays = torch.where(starved, delays + strength, delays)

    delays.masked_fill_(~alive[:, None, :], float("inf"))
    return _top_m_mask(delays, cfg.quorum).logical_and_(alive[:, None, :])


def omission_delivery_mask(cfg: SimConfig, seed: int, r: int, phase: int,
                           alive: torch.Tensor, drop_p: float,
                           trial_ids=None, recv_ids=None,
                           part=None) -> torch.Tensor:
    """Full delivery minus per-edge iid omission (SimConfig.drop_prob) ->
    bool [T, N_recv, N_send]: each (receiver, live sender) edge, self
    included, survives with probability 1 - drop_p, from a per-edge stream
    of its own (salt ``phase + 8``).  ``part`` (faults.partitions.
    PartitionSpec or None): during the epoch (r < heal_round) cross-group
    edges are lost too, deterministically."""
    t, n = alive.shape
    trial_ids, recv_ids = default_ids(trial_ids, recv_ids, t, n,
                                      alive.device)
    u = rng.edge_uniforms(seed, r, phase + 8, trial_ids, recv_ids,
                          rng.ids(n, device=alive.device))
    keep = u >= torch.as_tensor(drop_p, dtype=torch.float32, device=u.device)
    keep.logical_and_(alive[:, None, :])
    if part is not None and r < part.heal_round:
        g_recv = group_of(recv_ids, cfg.n_nodes, part.groups)
        g_send = group_of(rng.ids(n, device=alive.device), cfg.n_nodes,
                          part.groups)
        keep.logical_and_((g_recv[:, None] == g_send[None, :])[None])
    return keep


def _top_m_mask(delays: torch.Tensor, m: int) -> torch.Tensor:
    """bool mask of the m smallest entries per receiver row; among equal
    delays the lower sender index wins (a stable ascending sort).  With
    fewer than m live senders the inf-delay slots are selected too; callers
    intersect with alive."""
    order = torch.sort(delays, dim=-1, stable=True).indices[..., :m]
    mask = torch.zeros(delays.shape, dtype=torch.bool, device=delays.device)
    return mask.scatter_(-1, order, True)


def realize_counts_mask(counts: torch.Tensor, sent: torch.Tensor,
                        alive: torch.Tensor) -> torch.Tensor:
    """Realize per-receiver class-count quotas as an explicit delivery mask
    -> bool [T, N_recv, N_send]: sender s reaches receiver r iff s's rank
    among the live senders of its own class is below r's quota for that
    class, so ``dense_counts(mask, sent, alive)`` gives ``counts`` back.  A
    test witness, not on the runtime path.

    counts: int32 [T, N_recv, 3]; sent: int8 [T, N_send]; alive: bool
    [T, N_send]."""
    rank = torch.zeros(sent.shape, dtype=torch.int32, device=sent.device)
    for v in (VAL0, VAL1, VALQ):
        in_class = (sent == v) & alive
        r_v = torch.cumsum(in_class.to(torch.int32), dim=-1,
                           dtype=torch.int32) - 1
        rank = torch.where(in_class, r_v, rank)
    index = sent.to(torch.int64)[:, None, :].expand(
        counts.shape[0], counts.shape[1], sent.shape[-1])
    quota = torch.gather(counts, -1, index)
    return (rank[:, None, :] < quota) & alive[:, None, :]
