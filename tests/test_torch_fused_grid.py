"""The fused round kernel's cluster grid, modelled in numpy on the CPU.

csrc/round_kernels.cu runs T clusters of C blocks of W warps
(``fused_round_kernel`` at C = 1, ``fused_cluster_kernel`` above),
(C, W) = ``packed_round.fused_cluster(n_w, T, fits)``, the grid rule;
``fits[(C, W)]`` is what the CUDA occupancy query (``benor_fused_fits``)
says the card holds at once.  Block b serves trial
b // C as cluster rank b % C; its warp w is warp g = rank * W + w of the
trial and takes words g, g + C * W, ... below n_w, at most
``FUSED_KEEP`` of them.  The model checks that every word of every trial
is taken exactly once, that the grid is a multiple of C with C <= 16, that
no warp is left without a word, and that the T clusters fit the synthetic
card at once wherever some choice lets them.  The cards are modelled from
their SMs: blocks an SM from the kernel's registers, and a cluster's blocks
within one GPC (a cluster never spans two).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from benor_tpu_torch.ops import packed_round as pr

SRC = (Path(pr.__file__).resolve().parent.parent / "csrc"
       / "round_body.cuh")

# (name, SMs of each GPC, registers a thread): an H100 SXM (132 SMs) with
# the kernel at its launch bound's 64 registers and at 128, and a small
# card of 16 SMs
CARDS = {
    "h100-64regs": ((18, 18, 18, 18, 16, 16, 14, 14), 64),
    "h100-128regs": ((18, 18, 18, 18, 16, 16, 14, 14), 128),
    "16sms-64regs": ((8, 8), 64),
}
# the family's corners (T x n_w <= 8192 words, n_w a multiple of 16) and
# two widths between them
SHAPES = [(n_w, t) for n_w in (16, 32, 48, 128, 256)
          for t in (1, 8, 32, 256, 512) if t * n_w <= 8192]


def _fits(card):
    """{(C, W): clusters of C blocks of W warps the card holds at once}:
    blocks an SM by registers, warps and the 32-block limit, and a
    cluster's blocks in one GPC."""
    gpcs, regs = CARDS[card]
    out = {}
    for w in pr.FUSED_WARPS:
        per_sm = min(65536 // (regs * 32 * w), 64 // w, 32)
        for c in pr.FUSED_CLUSTERS:
            out[(c, w)] = sum(g * per_sm // c for g in gpcs)
    return out


def _words(n_w, trials, c, w):
    """Words taken by every warp of the grid -> (hits [T, n_w], words a
    warp [T * C * W])."""
    b = np.arange(trials * c)
    trial, rank = b // c, b % c
    g = rank[:, None] * w + np.arange(w)[None, :]            # [blocks, W]
    words = g[..., None] + np.arange(pr.FUSED_KEEP) * c * w  # [.., KEEP]
    taken = words < n_w
    hits = np.zeros((trials, n_w), np.int64)
    rows = np.broadcast_to(trial[:, None, None], words.shape)
    np.add.at(hits, (rows[taken], words[taken]), 1)
    return hits, taken.sum(-1).ravel()


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("n_w,trials", SHAPES)
def test_fused_grid_takes_every_word_once(n_w, trials, card):
    fits = _fits(card)
    c, w = pr.fused_cluster(n_w, trials, fits)
    assert c in pr.FUSED_CLUSTERS and c <= 16 and w in pr.FUSED_WARPS
    trial_of = np.arange(trials * c) // c            # the grid's blocks
    assert (np.bincount(trial_of, minlength=trials) == c).all()
    hits, per_warp = _words(n_w, trials, c, w)
    assert (hits == 1).all()                         # every word once
    assert per_warp.min() >= 1                       # no warp idle
    assert per_warp.max() <= pr.FUSED_KEEP           # all in registers
    assert per_warp.max() == -(-n_w // (c * w))
    one_wave = [cw for cw, n in fits.items()
                if trials <= n and cw[0] * cw[1] <= n_w
                <= cw[0] * cw[1] * pr.FUSED_KEEP]
    if one_wave:
        assert trials <= fits[(c, w)]                # T clusters at once
        assert c * w == max(a * b for a, b in one_wave)
    if card == "h100-64regs":
        assert one_wave       # the family fits the card at the launch bound


# Clusters at once by (C, W) that cudaOccupancyMaxActiveClusters reports
# for the kernel (64 registers) on an NVIDIA H100 80GB HBM3
H100_FITS = {(1, 16): 264, (1, 8): 528, (1, 4): 1056, (2, 16): 132,
             (2, 8): 264, (2, 4): 528, (4, 16): 62, (4, 8): 124, (4, 4): 248,
             (8, 16): 30, (8, 8): 62, (8, 4): 124, (16, 16): 14, (16, 8): 28,
             (16, 4): 58}


@pytest.mark.parametrize("n_w,trials,grid", [
    (256, 32, (16, 4)), (256, 8, (16, 16)), (256, 1, (16, 16)),
    (32, 256, (1, 16)), (16, 512, (1, 8)), (16, 1, (1, 16))])
def test_fused_grid_on_the_h100(n_w, trials, grid):
    """The rule on the card's own table at the family's shapes: one wave,
    the most warps a trial, a plain launch where it ties, else the most
    blocks a cluster."""
    assert pr.fused_cluster(n_w, trials, H100_FITS) == grid


def test_fused_grid_at_the_cap_is_a_cluster():
    """On the modelled H100 the cap N = 8192 takes a cluster at T = 32 and
    at T = 1, and the upstream default N = 10 (16 words) one block."""
    fits = _fits("h100-64regs")
    assert pr.fused_cluster(256, 32, fits)[0] > 1
    assert pr.fused_cluster(256, 1, fits) == (16, 16)
    assert pr.fused_cluster(16, 1, fits) == (1, 16)


def test_fused_rule_constants_match_the_kernel_source():
    """The rule's choices are the grids the launcher takes
    (``fused_dims_ok``) and the words a warp the kernel keeps."""
    src = SRC.read_text()

    def ints(name):
        m = re.search(rf"{name}(?:\[\])? = \{{?([0-9, ]+)\}}?;", src)
        return tuple(int(x) for x in m.group(1).split(","))

    assert ints("kFusedClusters") == pr.FUSED_CLUSTERS
    assert ints("kFusedWarpChoices") == pr.FUSED_WARPS
    assert ints("kFusedKeep") == (pr.FUSED_KEEP,)
    assert max(pr.FUSED_WARPS) == ints("kFusedMaxWarps")[0]
