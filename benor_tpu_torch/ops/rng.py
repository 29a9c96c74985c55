"""Stream keys and the ``fold_in`` chain (port of benor_tpu/ops/rng.py).

The kernel streams of ops/stream.py key on explicit 32-bit key words.  The
JAX package's other randomness derives every draw by CHAINED
``jax.random.fold_in`` from ``(seed, round, phase, trial, node)``; under
jax's partitionable threefry (jax 0.9.0) each step is plain threefry2x32:

    fold_in(key, d)  = threefry2x32(k0, k1, 0, d)    -> the new (k0, k1)
    bits(key)        = y0 ^ y1 of threefry2x32(k0, k1, 0, 0)
    uniform(key)     = bitcast((bits >> 9) | 0x3F800000) - 1   (no clip)
    bernoulli(key)   = uniform(key) < 0.5

A key is a pair of 32-bit words: Python ints for the per-round keys (derived
on the host, no device work) or int64 tensors masked to 32 bits for the
per-trial and per-lane keys (derived on the run's device, no sync).  Ids are
global, so a shard that folds in the ids it owns draws the same bits.
"""

from __future__ import annotations

import torch

from .stream import _M32, key_words, threefry2x32

__all__ = ["PHASE_PROPOSAL", "PHASE_VOTE", "PHASE_COIN", "PHASE_COIN_DEV",
           "key_words", "fold_in", "round_key", "grid_keys",
           "grid_uniforms", "edge_uniforms", "coin_flips",
           "weak_common_coin_flips", "ids"]

# Phase tags folded into the round key (and the stream salts of the
# kernels' draws) so proposal, vote and coin never share a stream.
PHASE_PROPOSAL = 0
PHASE_VOTE = 1
PHASE_COIN = 2
PHASE_COIN_DEV = 3   # weak-common-coin per-lane deviation stream

#: Edges one pass of ``edge_uniforms`` folds at a time.  The threefry runs
#: on int64 words (8 bytes an edge, about six tensors live), so a pass of
#: 2**24 edges peaks near 1 GB whatever T x R x S is.
EDGE_CHUNK = 1 << 24


def fold_in(key, data):
    """``jax.random.fold_in``: threefry2x32 of the key on counter (0, data)
    -> the new key's two words."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def _bits(key):
    """The 32 random bits of a scalar draw from ``key``."""
    y0, y1 = threefry2x32(key[0], key[1], 0, 0)
    return y0 ^ y1


def _uniform(key) -> torch.Tensor:
    """``jax.random.uniform(key)``: f32 in [0, 1), one per key."""
    word = ((_bits(key) >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def _bernoulli(key) -> torch.Tensor:
    """``jax.random.bernoulli(key)`` at p = 0.5."""
    return _uniform(key) < 0.5


def round_key(seed: int, r: int, phase: int):
    """Key for (round, phase), shared across all lanes (host ints)."""
    # benorlint: allow-host-sync — r is the host loop's round counter (the
    # key is a pair of host words)
    return fold_in(fold_in(key_words(seed), int(r)), phase)


def grid_keys(rp_key, trial_ids: torch.Tensor, node_ids: torch.Tensor):
    """Independent key per (trial, node) -> two int64 [T, N] word tensors.

    trial_ids [T], node_ids [N]: GLOBAL ids (int64)."""
    t0, t1 = fold_in(rp_key, trial_ids.to(torch.int64))
    return fold_in((t0[:, None], t1[:, None]),
                   node_ids.to(torch.int64)[None, :])


def grid_uniforms(seed: int, r: int, phase: int, trial_ids: torch.Tensor,
                  node_ids: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in [0, 1) per (trial, node) -> [T, N]."""
    return _uniform(grid_keys(round_key(seed, r, phase), trial_ids,
                              node_ids))


def edge_uniforms(seed: int, r: int, phase: int, trial_ids: torch.Tensor,
                  recv_ids: torch.Tensor,
                  send_ids: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in [0, 1) per (trial, receiver, sender) edge ->
    [T, R, S]: the dense path's delay tensor.  The key chain is
    round -> trial -> receiver -> sender, ids GLOBAL and never combined
    arithmetically.  The trial and receiver folds run once at [T] and
    [T, R]; the sender fold and the draw run in passes over the trials of
    at most ``EDGE_CHUNK`` edges, so the int64 threefry words never hold
    the whole [T, R, S]."""
    r0, r1 = grid_keys(round_key(seed, r, phase), trial_ids, recv_ids)
    send = send_ids.to(torch.int64)[None, None, :]
    t, n_recv, n_send = r0.shape[0], r0.shape[1], send.shape[-1]
    out = torch.empty((t, n_recv, n_send), dtype=torch.float32,
                      device=r0.device)
    step = max(1, EDGE_CHUNK // max(n_recv * n_send, 1))
    for lo in range(0, t, step):
        key = (r0[lo:lo + step, :, None], r1[lo:lo + step, :, None])
        out[lo:lo + step] = _uniform(fold_in(key, send))
    return out


def coin_flips(seed: int, r: int, trial_ids: torch.Tensor,
               node_ids: torch.Tensor, common: bool) -> torch.Tensor:
    """Fair coin -> int8 {0, 1}, shape [T, N].

    private: independent per (trial, node, round).
    common:  one shared coin per (trial, round), broadcast over the nodes
             (an expanded view: one [T] draw, no [T, N] work)."""
    kr = round_key(seed, r, PHASE_COIN)
    if common:
        bits = _bernoulli(fold_in(kr, trial_ids.to(torch.int64)))
        return bits.to(torch.int8)[:, None].expand(trial_ids.shape[0],
                                                   node_ids.shape[0])
    return _bernoulli(grid_keys(kr, trial_ids, node_ids)).to(torch.int8)


def weak_common_coin_flips(seed: int, r: int, trial_ids: torch.Tensor,
                           node_ids: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """epsilon-weak common coin -> int8 {0, 1}, shape [T, N]: each lane sees
    the round's shared coin with probability 1 - eps and its private flip
    otherwise.  The endpoints ARE the plain modes (eps 0 -> common, eps 1
    -> private), as in the JAX package."""
    if eps <= 0.0:
        return coin_flips(seed, r, trial_ids, node_ids, common=True)
    if eps >= 1.0:
        return coin_flips(seed, r, trial_ids, node_ids, common=False)
    shared = coin_flips(seed, r, trial_ids, node_ids, common=True)
    private = coin_flips(seed, r, trial_ids, node_ids, common=False)
    dev_u = grid_uniforms(seed, r, PHASE_COIN_DEV, trial_ids, node_ids)
    eps_f = torch.tensor(eps, dtype=torch.float32, device=dev_u.device)
    return torch.where(dev_u < eps_f, private, shared)


def ids(n: int, offset: int = 0, device=None) -> torch.Tensor:
    """Global id vector int64 [n] starting at ``offset``."""
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)
