"""The dense path's per-edge stream and delivery masks:
benor_tpu_torch.ops.rng.edge_uniforms and benor_tpu_torch.ops.scheduler
against the JAX package's, on the same numpy-made inputs — uniforms equal as
int32 bit patterns, masks equal entry for entry, rows with tied delays
included (the lower sender index wins).  The JAX functions run under
``jax.jit`` on numpy inputs: one XLA compile a case instead of one per
eager operation keeps the test process's compile count low."""

import numpy as np
import pytest
import torch

import jax

from benor_tpu.config import SimConfig as JCfg
from benor_tpu.faults.partitions import parse_partition as jparse_partition
from benor_tpu.ops import rng as jrng
from benor_tpu.ops import scheduler as jsched
from benor_tpu.ops.tally import dense_counts as j_dense_counts
from benor_tpu_torch.config import SimConfig as TCfg
from benor_tpu_torch.faults.partitions import (
    parse_partition as tparse_partition)
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import scheduler as tsched
from torch_ref_pool import prefetch, ref, start


J_EDGE_UNIFORMS = jax.jit(jrng.edge_uniforms)
J_TOP_M_MASK = jax.jit(jsched._top_m_mask, static_argnums=1)
J_QUORUM_MASK = jax.jit(jsched.quorum_delivery_mask, static_argnums=0)
J_OMISSION_MASK = jax.jit(jsched.omission_delivery_mask, static_argnums=0,
                          static_argnames="part")
J_FULL_MASK = jax.jit(jsched.full_delivery_mask)
J_REALIZE_MASK = jax.jit(jsched.realize_counts_mask)
J_DENSE_COUNTS = jax.jit(j_dense_counts)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _ids(lo, n):
    return np.arange(lo, lo + n, dtype=np.int32), trng.ids(n, lo)


def _senders(seed, t, n, p_alive):
    rs = np.random.default_rng(seed)
    sent = rs.integers(0, 3, (t, n)).astype(np.int8)
    alive = rs.random((t, n)) < p_alive
    return sent, alive


def _jax_edge_uniforms(seed, r, phase, t, n_recv, n_send, offs):
    """JAX's per-edge uniforms (``_jax_*``: a worker's calls, see
    torch_ref_pool)."""
    return np.asarray(J_EDGE_UNIFORMS(
        jax.random.key(seed), r, phase, _ids(offs[0], t)[0],
        _ids(offs[1], n_recv)[0], _ids(offs[2], n_send)[0]))


@pytest.mark.parametrize("seed,r,phase,t,n_recv,n_send,offs,chunk", [
    (0, 1, 0, 3, 7, 9, (0, 0, 0), 1 << 24),
    (7, 3, 1, 3, 7, 9, (5, 10, 0), 100),       # id offsets, chunked passes
    (123456789, 40, 33, 2, 5, 16, (1000, 2040, 3), 1),
    (2**32 + 5, 2, 8, 4, 12, 12, (0, 0, 0), 300),
])
@prefetch(lambda seed, r, phase, t, n_recv, n_send, offs, chunk: [
    (_jax_edge_uniforms, seed, r, phase, t, n_recv, n_send, offs)])
def test_edge_uniforms_match_jax_bits(monkeypatch, seed, r, phase, t, n_recv,
                                      n_send, offs, chunk):
    monkeypatch.setattr(trng, "EDGE_CHUNK", chunk)
    (_, tt), (_, tr), (_, ts) = (_ids(offs[0], t), _ids(offs[1], n_recv),
                                 _ids(offs[2], n_send))
    want = ref(_jax_edge_uniforms, seed, r, phase, t, n_recv, n_send, offs)
    got = trng.edge_uniforms(seed, r, phase, tt, tr, ts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("m", [1, 5, 11, 12, 16])
def test_top_m_mask_ties_match_jax(m):
    """Delays quantised to a few levels: every row holds ties at the m-th
    place, and some rows hold inf slots among the m."""
    rs = np.random.default_rng(m)
    delays = (rs.integers(0, 4, (3, 9, 16)) / 4.0).astype(np.float32)
    delays[rs.random(delays.shape) < 0.2] = np.inf
    want = np.asarray(J_TOP_M_MASK(delays, m))
    got = tsched._top_m_mask(torch.from_numpy(delays), m).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == m).all()
    srt = np.sort(delays, axis=-1)
    assert (srt[..., m - 1] == srt[..., min(m, 15)]).any()   # ties at m


def _jax_quorum_mask(kw, seed, r, phase, sent, alive, t_off, r_off,
                     n_recv):
    t, _ = alive.shape
    return np.asarray(J_QUORUM_MASK(JCfg(**kw), jax.random.key(seed), r,
                                    phase, sent, alive, _ids(t_off, t)[0],
                                    _ids(r_off, n_recv)[0]))


def _quorum_args(kw, seed, r, phase, sent, alive, t_off=0, r_off=0,
                 n_recv=None):
    n_recv = alive.shape[1] if n_recv is None else n_recv
    return (kw, seed, r, phase, sent, alive, t_off, r_off, n_recv)


def _quorum_masks(kw, seed, r, phase, sent, alive, t_off=0, r_off=0,
                  n_recv=None):
    args = _quorum_args(kw, seed, r, phase, sent, alive, t_off, r_off,
                        n_recv)
    t, n_recv = alive.shape[0], args[-1]
    _, tt = _ids(t_off, t)
    _, tr = _ids(r_off, n_recv)
    want = ref(_jax_quorum_mask, *args)
    got = tsched.quorum_delivery_mask(
        TCfg(**kw), seed, r, phase, torch.from_numpy(sent),
        torch.from_numpy(alive), tt, tr).numpy()
    return got, want


def _quorum_kw(sched, strength, p_alive, f):
    n, t = 40, 3
    kw = dict(n_nodes=n, n_faulty=f, trials=t, delivery="quorum",
              scheduler=sched, adversary_strength=strength, path="dense")
    return kw, _senders(11, t, n, p_alive)


@pytest.mark.parametrize("sched,strength", [
    ("uniform", 0.0), ("biased", 0.0), ("biased", 0.5), ("biased", 1.0),
    ("biased", 3.0)])
@pytest.mark.parametrize("p_alive,f", [(1.0, 12), (0.85, 12), (0.5, 4)],
                         ids=["all-alive", "dead-senders", "under-quorum"])
@prefetch(lambda sched, strength, p_alive, f: [
    (_jax_quorum_mask,
     *_quorum_args(_quorum_kw(sched, strength, p_alive, f)[0], 5, 2, 1,
                   *_quorum_kw(sched, strength, p_alive, f)[1]))])
def test_quorum_delivery_mask_matches_jax(sched, strength, p_alive, f):
    n = 40
    kw, (sent, alive) = _quorum_kw(sched, strength, p_alive, f)
    got, want = _quorum_masks(kw, 5, 2, 1, sent, alive)
    np.testing.assert_array_equal(got, want)
    assert not (got & ~alive[:, None, :]).any()
    live = alive.sum(-1)[:, None]
    assert (got.sum(-1) == np.minimum(n - f, live)).all()
    if p_alive == 0.5:
        assert (live < n - f).any()          # fewer than m alive somewhere


_SHARDED_KW = dict(n_nodes=40, n_faulty=10, trials=2, delivery="quorum",
                   scheduler="biased", adversary_strength=1.0, path="dense")


@prefetch(lambda: [(_jax_quorum_mask,
                    *_quorum_args(_SHARDED_KW, 9, 4, 0,
                                  *_senders(3, 2, 40, 0.9), t_off=4,
                                  r_off=17, n_recv=12))])
def test_quorum_delivery_mask_sharded_receivers_match_jax():
    """Receivers 16..27 of trials 4..5: the ids are global, R != S."""
    n, t = 40, 2
    kw = _SHARDED_KW
    sent, alive = _senders(3, t, n, 0.9)
    got, want = _quorum_masks(kw, 9, 4, 0, sent, alive, t_off=4, r_off=17,
                              n_recv=12)
    assert got.shape == (t, 12, n)
    np.testing.assert_array_equal(got, want)


def test_full_delivery_mask_matches_jax():
    _, alive = _senders(1, 3, 20, 0.8)
    want = np.asarray(J_FULL_MASK(alive))
    got = tsched.full_delivery_mask(torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_omission_mask(kw, key, r, alive, drop_p):
    part = (jparse_partition(kw["partition"]) if kw.get("partition")
            else None)
    extra = {} if part is None else dict(part=part)
    return np.asarray(J_OMISSION_MASK(JCfg(**kw), jax.random.key(key), r, 1,
                                      alive, drop_p, **extra))


def _omission_kw(drop_p):
    return dict(n_nodes=24, n_faulty=6, trials=3, delivery="all",
                drop_prob=drop_p, path="dense")


@pytest.mark.parametrize("drop_p", [0.0, 0.2, 0.75])
@prefetch(lambda drop_p: [(_jax_omission_mask, _omission_kw(drop_p), 4, 3,
                           _senders(2, 3, 24, 0.9)[1], drop_p)])
def test_omission_delivery_mask_matches_jax(drop_p):
    n, t = 24, 3
    kw = _omission_kw(drop_p)
    _, alive = _senders(2, t, n, 0.9)
    want = ref(_jax_omission_mask, kw, 4, 3, alive, drop_p)
    got = tsched.omission_delivery_mask(
        TCfg(**kw), 4, 3, 1, torch.from_numpy(alive), drop_p).numpy()
    np.testing.assert_array_equal(got, want)
    if drop_p == 0.0:
        assert (got == alive[:, None, :]).all()


_EPOCH_KW = dict(n_nodes=24, n_faulty=6, trials=3, delivery="all",
                 drop_prob=0.1, path="dense", partition="groups:3:3")


@pytest.mark.parametrize("r", [1, 2, 3, 5])
@prefetch(lambda r: [(_jax_omission_mask, _EPOCH_KW, 6, r,
                      _senders(5, 3, 24, 0.9)[1], 0.1)])
def test_omission_partition_epoch_is_not_ported(r):
    """The partition epoch on the omission mask, now ported: cross-group
    edges are lost while r < heal_round ('groups:3:3' at N = 24), as in
    the JAX package's ``omission_delivery_mask(part=...)``."""
    n, t = 24, 3
    kw = _EPOCH_KW
    _, alive = _senders(5, t, n, 0.9)
    tpart = tparse_partition(kw["partition"])
    want = ref(_jax_omission_mask, kw, 6, r, alive, 0.1)
    got = tsched.omission_delivery_mask(
        TCfg(**kw), 6, r, 1, torch.from_numpy(alive), 0.1,
        part=tpart).numpy()
    np.testing.assert_array_equal(got, want)
    grp = np.arange(n) * 3 // n
    cross = grp[:, None] != grp[None, :]
    assert got[:, cross].any() == (r >= tpart.heal_round)


def test_realize_counts_mask_matches_jax_and_gives_the_counts_back():
    t, n, n_recv = 3, 30, 7
    sent, alive = _senders(8, t, n, 0.85)
    rs = np.random.default_rng(9)
    pops = np.stack([((sent == v) & alive).sum(-1) for v in (0, 1, 2)], -1)
    counts = (rs.random((t, n_recv, 3)) * (pops[:, None, :] + 1)).astype(
        np.int32)
    want = np.asarray(J_REALIZE_MASK(counts, sent, alive))
    mask = tsched.realize_counts_mask(torch.from_numpy(counts),
                                      torch.from_numpy(sent),
                                      torch.from_numpy(alive))
    np.testing.assert_array_equal(mask.numpy(), want)
    back = tdense.dense_counts(mask, torch.from_numpy(sent),
                               torch.from_numpy(alive))
    np.testing.assert_array_equal(back.numpy(), counts)
    np.testing.assert_array_equal(
        np.asarray(J_DENSE_COUNTS(want, sent, alive)), counts)
