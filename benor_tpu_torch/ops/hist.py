"""The unfused histogram round's per-lane samplers and coins
(port of benor_tpu/ops/pallas_hist.py, the four kernel entry points).

    cf_counts        — per-lane CF tallies h0, h1 | h0, hq from the global
                       class histogram -> int32 [T, N, 3]
    coin_flips       — private fair coins -> int8 [T, N]
    equiv_counts     — the equivocate regime's mixed-population tallies
                       (three CF draws + a Binomial(h_b, 1/2) split)
                       -> int32 [T, N, 3]
    weak_coin_flips  — eps-weak common coins: the private bit where the
                       lane's deviation uniform < eps, else the trial's
                       shared bit -> int8 [T, N]

Each wrapper launches its hand-written CUDA kernel (csrc/hist_kernels.cu)
for CUDA operands and counts the launch in its ``launches`` attribute; for
CPU operands it runs its plain torch version, which the tests hold against
the JAX package's Pallas kernels and ``chip_smoke.py`` holds against the
kernel on the card.  Any other device raises.

Streams are the JAX kernels' own: key ``stream_scal(seed, r, salt)``, one
threefry block per lane on the GLOBAL (node, trial) counters, so N needs
no padding.  Salts: the sampler's raw phase tag; the equivocate sampler's
second block phase + 64; both coins 255 (the weak coin's word 0 is the
private bit, word 1 its deviation uniform).  The plain versions run the
JAX kernels' f32 ops in the same order (ops/stream.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .launch import check, count_vecs, on_cpu, ptr, raise_on, stream
from .stream import (_COIN_SALT, _EQUIV_SALT_OFFSET, bits_to_uniform,
                     cf_pair_draws, equiv_pair_draws, lane_ids, stream_scal,
                     threefry2x32)

#: Threads a block of the histogram kernels (csrc/hist_kernels.cu
#: kThreads).
THREADS = 256
#: Consecutive nodes a thread of the coin kernels takes a pass
#: (csrc/hist_kernels.cu kCoinNodes).
COIN_NODES = 8
#: Nodes a block takes a pass, by the wave query's kernel id: cf_counts
#: (0) and equiv_counts (1) one a thread, coin_flips (2) and
#: weak_coin_flips (3) COIN_NODES a thread.
BLOCK_NODES = (THREADS, THREADS, THREADS * COIN_NODES, THREADS * COIN_NODES)


# --------------------------------------------------------------------------
# Plain versions (the JAX kernel bodies, op for op).
# --------------------------------------------------------------------------


def cf_counts_plain(seed, r, phase, hist, m, n_nodes):
    """Plain version of the CF sampler kernel -> int32 [T, N, 3]."""
    t, device = hist.shape[0], hist.device
    mf = torch.tensor(float(m), dtype=torch.float32, device=device)
    h0, h1 = cf_pair_draws(m, stream_scal(seed, r, phase), count_vecs(hist),
                           (t, n_nodes), device)
    hq = torch.clamp_min(mf - h0 - h1, 0.0)
    return torch.stack([h0, h1, hq], dim=-1).to(torch.int32)


def coin_flips_plain(seed, r, trials, n_nodes, device):
    """Plain version of the private-coin kernel -> int8 [T, N]."""
    node, trial = lane_ids(trials, n_nodes, device)
    ck = stream_scal(seed, r, _COIN_SALT)
    bits, _ = threefry2x32(ck[0], ck[1], node, trial)
    return (bits & 1).to(torch.int8)


def equiv_counts_plain(seed, r, phase, hist, n_equiv, m, n_nodes):
    """Plain version of the equivocate-regime sampler kernel -> int32
    [T, N, 3]: h_b delivered equivocators ~ CF, the honest split of the
    rest, and a Binomial(h_b, 1/2) class split of the h_b (the trial's
    terms once a trial, as the kernel computes them)."""
    counts = equiv_pair_draws(
        m, stream_scal(seed, r, phase),
        stream_scal(seed, r, phase + _EQUIV_SALT_OFFSET), count_vecs(hist),
        count_vecs(n_equiv), (hist.shape[0], n_nodes), hist.device)
    return torch.stack(counts, dim=-1).to(torch.int32)


def weak_coin_flips_plain(seed, r, trials, n_nodes, eps, shared):
    """Plain version of the weak-coin kernel -> int8 [T, N]."""
    device = shared.device
    node, trial = lane_ids(trials, n_nodes, device)
    ck = stream_scal(seed, r, _COIN_SALT)
    pbits, dbits = threefry2x32(ck[0], ck[1], node, trial)
    private = (pbits & 1).to(torch.int32)
    dev = bits_to_uniform(dbits) < torch.tensor(eps, dtype=torch.float32,
                                                device=device)
    return torch.where(dev, private,
                       shared.to(torch.int32)[:, None]).to(torch.int8)


# --------------------------------------------------------------------------
# Kernel wrappers: device dispatch, checks, launch, launch counters.
# --------------------------------------------------------------------------


def tile_blocks(wave: int, n_nodes: int, trials: int,
                block_nodes: int = THREADS) -> int:
    """Blocks a trial of a histogram kernel for one ``wave`` of the kernel
    (the SMs times the blocks an SM holds): as many as fit ``trials`` times
    in the wave, at least one, at most one per ``block_nodes`` nodes (the
    nodes a block takes a pass).  The grid is ``trials`` times that; block
    b serves trial b // blocks."""
    return max(1, min(wave // max(trials, 1), -(-n_nodes // block_nodes)))


@functools.cache
def hist_blocks(lib, kernel: int, n_nodes: int, trials: int, device) -> int:
    """Blocks a trial of cf_counts (``kernel`` 0), equiv_counts (1),
    coin_flips (2) or weak_coin_flips (3) on ``device``: ``tile_blocks`` of
    the kernel's wave from the CUDA occupancy query, worked out once per
    shape.  A failed query raises."""
    wave = ctypes.c_int(0)
    with torch.cuda.device(device):
        raise_on(lib.benor_hist_wave(kernel, ctypes.byref(wave)),
                 "hist_wave")
    return tile_blocks(wave.value, n_nodes, trials, BLOCK_NODES[kernel])


def _launch_cf_counts(lib, key, hist_f, m, n_nodes):
    t = hist_f.shape[0]
    out = torch.empty((t, n_nodes, 3), dtype=torch.int32,
                      device=hist_f.device)
    blocks = hist_blocks(lib, 0, n_nodes, t, hist_f.device)
    raise_on(lib.benor_cf_counts(ptr(hist_f), ptr(out), t, n_nodes, blocks,
                                 key[0], key[1], float(m),
                                 stream(hist_f.device)), "cf_counts")
    return out


def _launch_coin_flips(lib, key, trials, n_nodes, device):
    out = torch.empty((trials, n_nodes), dtype=torch.int8, device=device)
    blocks = hist_blocks(lib, 2, n_nodes, trials, device)
    raise_on(lib.benor_coin_flips(ptr(out), trials, n_nodes, blocks, key[0],
                                  key[1], stream(device)), "coin_flips")
    return out


def _launch_equiv_counts(lib, key, key2, hist_f, ne_f, m, n_nodes):
    t = hist_f.shape[0]
    out = torch.empty((t, n_nodes, 3), dtype=torch.int32,
                      device=hist_f.device)
    blocks = hist_blocks(lib, 1, n_nodes, t, hist_f.device)
    raise_on(lib.benor_equiv_counts(
        ptr(hist_f), ptr(ne_f), ptr(out), t, n_nodes, blocks, key[0], key[1],
        key2[0], key2[1], float(m), stream(hist_f.device)), "equiv_counts")
    return out


def _launch_weak_coin_flips(lib, key, trials, n_nodes, eps, shared_i):
    out = torch.empty((trials, n_nodes), dtype=torch.int8,
                      device=shared_i.device)
    blocks = hist_blocks(lib, 3, n_nodes, trials, shared_i.device)
    raise_on(lib.benor_weak_coin_flips(
        ptr(shared_i), ptr(out), trials, n_nodes, blocks, key[0], key[1],
        float(eps), stream(shared_i.device)), "weak_coin_flips")
    return out


def cf_counts(seed, r, phase, hist, m, n_nodes):
    """Fused histogram-path quorum sampler -> int32 [T, N, 3].  ``hist``:
    int32 [T, 3] global class counts; ``m``: the quorum."""
    if on_cpu(hist.device, "cf_counts"):
        return cf_counts_plain(seed, r, phase, hist, m, n_nodes)
    from ._build import load_library

    hist_f = count_vecs(hist)
    check("hist", hist_f, torch.float32, (hist.shape[0], 3), hist.device)
    out = _launch_cf_counts(load_library(), stream_scal(seed, r, phase),
                            hist_f, m, n_nodes)
    cf_counts.launches += 1
    return out


def coin_flips(seed, r, trials, n_nodes, device):
    """Private per-(trial, node, round) fair coins -> int8 [T, N] on
    ``device``."""
    device = torch.device(device)
    if on_cpu(device, "coin_flips"):
        return coin_flips_plain(seed, r, trials, n_nodes, device)
    from ._build import load_library

    out = _launch_coin_flips(load_library(), stream_scal(seed, r, _COIN_SALT),
                             trials, n_nodes, device)
    coin_flips.launches += 1
    return out


def equiv_counts(seed, r, phase, hist, n_equiv, m, n_nodes):
    """Fused equivocate-regime quorum sampler -> int32 [T, N, 3].
    ``hist``: int32 [T, 3] global HONEST class counts; ``n_equiv``: int32
    [T] live equivocators."""
    if on_cpu(hist.device, "equiv_counts"):
        return equiv_counts_plain(seed, r, phase, hist, n_equiv, m, n_nodes)
    from ._build import load_library

    t = hist.shape[0]
    hist_f, ne_f = count_vecs(hist), count_vecs(n_equiv)
    check("hist", hist_f, torch.float32, (t, 3), hist.device)
    check("n_equiv", ne_f, torch.float32, (t,), hist.device)
    out = _launch_equiv_counts(
        load_library(), stream_scal(seed, r, phase),
        stream_scal(seed, r, phase + _EQUIV_SALT_OFFSET), hist_f, ne_f, m,
        n_nodes)
    equiv_counts.launches += 1
    return out


def weak_coin_flips(seed, r, trials, n_nodes, eps, shared):
    """eps-weak common coins -> int8 [T, N].  ``shared``: the round's
    common bit per trial, [T] (rng.coin_flips(common=True))."""
    if on_cpu(shared.device, "weak_coin_flips"):
        return weak_coin_flips_plain(seed, r, trials, n_nodes, eps, shared)
    from ._build import load_library

    shared_i = shared.to(torch.int32).contiguous()
    check("shared", shared_i, torch.int32, (trials,), shared.device)
    out = _launch_weak_coin_flips(load_library(),
                                  stream_scal(seed, r, _COIN_SALT), trials,
                                  n_nodes, eps, shared_i)
    weak_coin_flips.launches += 1
    return out


cf_counts.launches = 0
coin_flips.launches = 0
equiv_counts.launches = 0
weak_coin_flips.launches = 0

#: The kernel wrappers, by name (their launch counters are ``.launches``).
KERNELS = {"cf_counts": cf_counts, "coin_flips": coin_flips,
           "equiv_counts": equiv_counts, "weak_coin_flips": weak_coin_flips}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
