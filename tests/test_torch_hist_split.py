"""The redesigned counts kernels' host-side parts, on the CPU.

- The equivocate tally in its split form (ops/stream.py ``equiv_trial``, the
  per-trial terms, + ``equiv_draws``, the lane's remainder: the plain twins
  of csrc/stream.cuh, which ``equiv_counts_plain`` runs) against the whole
  ``_equiv_kernel`` body (a torch copy here, per-lane ``cf_draw``s) and the
  JAX package's Pallas kernel in interpret mode, bit for bit, on edge
  operands and on random histograms at N = 1M magnitudes (a few thousand
  lanes each).
- A numpy model of the trial-aligned grid (``hist.tile_blocks`` and the
  kernels' index map) reaches every (trial, node) lane exactly once.
- ``cf_counts_plain`` and ``equiv_counts_plain`` against the Pallas kernels
  on two of chip_smoke.py's edge-histogram rows at N = 1000.

The JAX side runs under ``jax.jit`` on numpy inputs and JAX's caches are
cleared at module teardown, to keep the test process's compile count low.
"""

import jax
import numpy as np
import pytest
import torch

from benor_tpu.ops import pallas_hist as jh
from benor_tpu_torch.ops import hist as th
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import stream as ts
from chip_smoke import edge_hists
from torch_ref_pool import prefetch, ref, start

SEED, ROUND = 5, 2
N_LANES = 4096

# (c0, c1, cq, n_equiv) of one trial at the quorum M_EDGE
M_EDGE = 72
EDGE_ROWS = np.array([
    [40, 30, 10, 0],       # n_equiv = 0
    [0, 0, 0, 96],         # n_equiv = total (no honest sender)
    [30, 30, 20, 80],      # n_equiv = the honest total
    [0, 50, 26, 20],       # c0 = 0
    [50, 0, 26, 20],       # c1 = 0
    [0, 0, 0, 20],         # total_h = 0, m above the total
    [30, 20, 6, 16],       # m = total
    [2048, 1800, 248, 0],  # an ordinary population of 4096
], dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches(request):
    start(request)
    yield
    jax.clear_caches()


def _equiv_whole(seed, r, phase, hist, n_equiv, m, n_nodes):
    """``_equiv_kernel``'s body as one per-lane expression (each draw's
    population and sample-size terms computed in every lane), f32 op for
    op -> the three f32 counts."""
    node, trial = ts.lane_ids(hist.shape[0], n_nodes, "cpu")
    k = ts.stream_scal(seed, r, phase)
    k2 = ts.stream_scal(seed, r, phase + ts._EQUIV_SALT_OFFSET)
    b0, b1 = ts.threefry2x32(k[0], k[1], node, trial)
    b2, b3 = ts.threefry2x32(k2[0], k2[1], node, trial)
    u0, u1, u_b, u_s = (ts.bits_to_uniform(b) for b in (b0, b1, b2, b3))
    cls = hist.to(torch.float32)
    c0, c1, cq = cls[:, 0:1], cls[:, 1:2], cls[:, 2:3]
    ne = n_equiv.to(torch.float32)[:, None]
    total_h = c0 + c1 + cq
    total = total_h + ne
    mf = torch.tensor(float(m))
    h_b = ts.cf_draw(u_b, total, ne, mf)
    rem = torch.clamp_min(mf - h_b, 0.0)
    h0 = ts.cf_draw(u0, total_h, c0, rem)
    h1 = ts.cf_draw(u1, torch.clamp_min(total_h - c0, 0.0), c1,
                    torch.clamp_min(rem - h0, 0.0))
    hq = torch.clamp_min(rem - h0 - h1, 0.0)
    z = ts.ndtri_clipped(u_s)
    bs = torch.round(h_b * 0.5 + z * torch.sqrt(h_b) * 0.5)
    bs = torch.minimum(torch.clamp_min(bs, 0.0), h_b)
    return h0 + (h_b - bs), h1 + bs, hq


def _equiv_split(seed, r, phase, hist, n_equiv, m, n_nodes):
    """The split form's f32 counts (what equiv_counts_plain casts)."""
    node, trial = ts.lane_ids(hist.shape[0], n_nodes, "cpu")
    k = ts.stream_scal(seed, r, phase)
    k2 = ts.stream_scal(seed, r, phase + ts._EQUIV_SALT_OFFSET)
    bits = (*ts.threefry2x32(k[0], k[1], node, trial),
            *ts.threefry2x32(k2[0], k2[1], node, trial))
    e = ts.equiv_trial(hist.to(torch.float32), n_equiv.to(torch.float32), m)
    return ts.equiv_draws(e, *(ts.bits_to_uniform(b) for b in bits))


def _assert_split_equals_whole(hist, n_equiv, m):
    args = (SEED, ROUND, trng.PHASE_VOTE, torch.from_numpy(hist),
            torch.from_numpy(n_equiv), m, N_LANES)
    for a, b in zip(_equiv_split(*args), _equiv_whole(*args)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    out = th.equiv_counts_plain(*args)
    assert out.dtype == torch.int32 and tuple(out.shape) == \
        (hist.shape[0], N_LANES, 3)
    return out


def _jax_equiv_counts(hist, n_equiv, m):
    """The JAX package's equivocation kernel in interpret mode (a worker's
    call, see torch_ref_pool)."""
    return np.asarray(jh.equiv_counts_pallas(
        jax.random.key(SEED), np.int32(ROUND), trng.PHASE_VOTE, hist,
        n_equiv, m, N_LANES, interpret=True))


def _assert_split_equals_pallas(hist, n_equiv, m):
    out = _assert_split_equals_whole(hist, n_equiv, m)
    j = ref(_jax_equiv_counts, hist, n_equiv, m)
    np.testing.assert_array_equal(out.numpy(), j)


def _edge_operands():
    return EDGE_ROWS[:, :3].copy(), EDGE_ROWS[:, 3].copy()


@pytest.mark.parametrize("m", [M_EDGE, 1])
@prefetch(lambda m: [(_jax_equiv_counts, *_edge_operands(), m)])
def test_equiv_split_equals_whole_and_pallas_on_edge_operands(m):
    hist, n_equiv = _edge_operands()
    if m == M_EDGE:
        assert hist[6].sum() + n_equiv[6] == m          # the m = total row
    _assert_split_equals_pallas(hist, n_equiv, m)


def _magnitudes(m):
    rs = np.random.default_rng(m)
    n_equiv = rs.integers(0, 250_000, size=8).astype(np.int32)
    hist = np.stack([rs.multinomial(1_000_000 - int(ne), [0.45, 0.45, 0.1])
                     for ne in n_equiv]).astype(np.int32)
    hist[:2] = rs.integers(0, 1_000_000, size=(2, 3))   # totals up to 3M
    n_equiv[2] = 0
    return hist, n_equiv


@pytest.mark.parametrize("m", [600_000, 800_000])
@prefetch(lambda m: [(_jax_equiv_counts, *_magnitudes(m), m)])
def test_equiv_split_equals_whole_and_pallas_at_1m_magnitudes(m):
    hist, n_equiv = _magnitudes(m)
    _assert_split_equals_pallas(hist, n_equiv, m)


def _grid_map(n_nodes, trials, blocks):
    """The counts kernels' index map in numpy.  The grid is trials * blocks
    blocks of THREADS threads; block b serves trial b // blocks and walks
    nodes (b - trial * blocks) * THREADS + thread with a stride of
    blocks * THREADS.  The walk depends on b only through bx = b - trial *
    blocks, so lane (trial, node) is reached sum over bx of served[trial,
    bx] * walk[bx, node] times -> (served: blocks b of each (trial, bx),
    [T, blocks]; hits: how often the walks of bx = 0 .. blocks-1 together
    reach each node, [N])."""
    b = np.arange(trials * blocks)
    trial = b // blocks
    bx = b - trial * blocks
    assert (trial < trials).all() and (bx >= 0).all() and (bx < blocks).all()
    served = np.zeros((trials, blocks), np.int64)
    np.add.at(served, (trial, bx), 1)
    stride = blocks * th.THREADS
    starts = (np.arange(blocks)[:, None] * th.THREADS
              + np.arange(th.THREADS)[None, :]).ravel()
    nodes = (starts[None, :] + np.arange(-(-n_nodes // stride))[:, None]
             * stride).ravel()
    return served, np.bincount(nodes[nodes < n_nodes], minlength=n_nodes)


@pytest.mark.parametrize("trials", [1, 7, 32, 1000])
@pytest.mark.parametrize("n_nodes", [1, 31, 33, 1000, 1_000_003])
def test_grid_reaches_every_lane_once(n_nodes, trials):
    """Every (trial, bx) is served by one block and the walks of a trial's
    blocks reach every node once, so every lane is reached once, with its
    own trial."""
    for wave in (1, 132, 528, 1056):
        blocks = th.tile_blocks(wave, n_nodes, trials)
        assert 1 <= blocks <= -(-n_nodes // th.THREADS)
        assert trials * blocks <= max(wave, trials)      # one wave if T fits
        served, hits = _grid_map(n_nodes, trials, blocks)
        assert (served == 1).all() and (hits == 1).all()


def _edge_hist_rows():
    n = 1000
    m = n - int(0.40 * n)
    return edge_hists(n, m, 10, "cpu")[[6, 7]].numpy()


def _jax_edge_hist_counts(hist):
    """The JAX package's CF and equivocation kernels in interpret mode on
    the rows (a worker's call, see torch_ref_pool)."""
    n = 1000
    m = n - int(0.40 * n)
    j_cf = jh.cf_counts_pallas(jax.random.key(SEED), np.int32(ROUND),
                               trng.PHASE_PROPOSAL, hist, m, n,
                               interpret=True)
    n_equiv = np.array([0, hist[1].sum()], np.int32)
    j_eq = jh.equiv_counts_pallas(jax.random.key(SEED), np.int32(ROUND),
                                  trng.PHASE_VOTE, hist, n_equiv,
                                  n - n // 5, n, interpret=True)
    return np.asarray(j_cf), np.asarray(j_eq)


@prefetch(lambda: [(_jax_edge_hist_counts, _edge_hist_rows())])
def test_counts_plain_match_pallas_on_edge_hist_rows():
    """Two of chip_smoke.py's edge-histogram rows (the quorum above the
    total; c0 near the total, so m - p0 <= 0 in many lanes) at N = 1000,
    the equivocators cycling as chip_smoke's fixture takes them (0, the
    trial's total)."""
    n = 1000
    m = n - int(0.40 * n)
    hist = _edge_hist_rows()
    j_cf, j_eq = ref(_jax_edge_hist_counts, hist)
    out = th.cf_counts_plain(SEED, ROUND, trng.PHASE_PROPOSAL,
                             torch.from_numpy(hist), m, n)
    np.testing.assert_array_equal(out.numpy(), j_cf)
    n_equiv = np.array([0, hist[1].sum()], np.int32)
    em = n - n // 5
    out = th.equiv_counts_plain(SEED, ROUND, trng.PHASE_VOTE,
                                torch.from_numpy(hist),
                                torch.from_numpy(n_equiv), em, n)
    np.testing.assert_array_equal(out.numpy(), j_eq)
