"""The coin kernels' trial-aligned grid, modelled in numpy on the CPU.

csrc/hist_kernels.cu ``coin_flips_kernel`` and ``weak_coin_flips_kernel``
run T x B blocks of ``THREADS`` threads, B = ``hist.tile_blocks(wave, N,
T, hist.BLOCK_NODES[2])``.  Block b serves trial b // B.  Its thread t
takes ``COIN_NODES`` = K consecutive nodes a pass, from (bx * THREADS + t)
* K (bx = b - trial * B) with a stride of B * THREADS * K nodes.  A pass
stores its K coin bytes as one K-byte word where the row's byte address
trial * N is K-aligned and the K nodes lie in the row, else one byte a
node inside the row.  The model checks that every (trial, node) byte is
written exactly once, that no byte lies outside [0, T * N), and that the
K-byte stores sit at K-aligned addresses.  The output's base address is
taken as aligned, as torch's allocations are.

Also: the counts kernels' blocks a trial are what they were before
``tile_blocks`` took the nodes a block.
"""

import numpy as np
import pytest

from benor_tpu_torch.ops import hist as th

K = th.COIN_NODES


def _served(trials, blocks):
    """Blocks of each (trial, bx) under the block -> trial map, [T, B]."""
    b = np.arange(trials * blocks)
    trial = b // blocks
    served = np.zeros((trials, blocks), np.int64)
    np.add.at(served, (trial, b - trial * blocks), 1)
    return served


def _passes(n_nodes, blocks):
    """First node of every pass of one trial's blocks (the walk depends on
    the block only through bx): thread t of block bx starts at (bx * THREADS
    + t) * K and strides B * THREADS * K nodes while the node is < N."""
    starts = (np.arange(blocks)[:, None] * th.THREADS
              + np.arange(th.THREADS)[None, :]).ravel() * K
    stride = blocks * th.THREADS * K
    nodes = (starts[None, :]
             + np.arange(-(-n_nodes // stride))[:, None] * stride).ravel()
    return nodes[nodes < n_nodes]


def _row_stores(row, n_nodes, nodes):
    """One trial's stores: (addresses of the K-byte words, addresses of the
    single bytes) for the passes starting at ``nodes`` of the row at byte
    address ``row``."""
    wide = (nodes + K <= n_nodes) if row % K == 0 else np.zeros(
        nodes.shape, bool)
    narrow = (nodes[~wide][:, None] + np.arange(K)[None, :]).ravel()
    return row + nodes[wide], row + narrow[narrow < n_nodes]


@pytest.mark.parametrize("wave", [1, 132, 1056])
@pytest.mark.parametrize("trials", [1, 7, 32])
@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 33, 1000, 1_000_003])
def test_coin_grid_writes_every_byte_once(n_nodes, trials, wave):
    blocks = th.tile_blocks(wave, n_nodes, trials, th.BLOCK_NODES[2])
    assert th.BLOCK_NODES[2] == th.BLOCK_NODES[3] == th.THREADS * K
    # the C launchers' cap, which keeps node + stride below 2^32
    assert 1 <= blocks <= max(1, -(-n_nodes // (th.THREADS * K)))
    assert trials * blocks <= max(wave, trials)          # one wave if T fits
    assert (_served(trials, blocks) == 1).all()
    nodes = _passes(n_nodes, blocks)
    n_wide = 0
    for trial in range(trials):
        row = trial * n_nodes
        wide, narrow = _row_stores(row, n_nodes, nodes)
        assert (wide % K == 0).all()
        addr = np.concatenate([(wide[:, None] + np.arange(K)).ravel(),
                               narrow])
        assert addr.min() >= 0 and addr.max() < trials * n_nodes
        hits = np.bincount(addr - row, minlength=n_nodes)
        assert hits.shape == (n_nodes,) and (hits == 1).all()
        n_wide += wide.size
    if n_nodes >= K:                  # row 0 is aligned: it takes words
        assert n_wide >= n_nodes // K


def _tile_blocks_before(wave, n_nodes, trials):
    """The counts kernels' blocks a trial before tile_blocks took the
    nodes a block: at most one per 256 nodes."""
    return max(1, min(wave // max(trials, 1), -(-n_nodes // 256)))


@pytest.mark.parametrize("trials", [1, 7, 32, 1000])
@pytest.mark.parametrize("n_nodes", [1, 31, 33, 1000, 1_000_003])
def test_tile_blocks_keeps_the_counts_kernels_grid(n_nodes, trials):
    for wave in (1, 132, 528, 1056):
        before = _tile_blocks_before(wave, n_nodes, trials)
        assert th.tile_blocks(wave, n_nodes, trials) == before
        for kernel in (0, 1):
            assert th.tile_blocks(wave, n_nodes, trials,
                                  th.BLOCK_NODES[kernel]) == before
