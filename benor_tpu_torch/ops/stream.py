"""The shared device math of the round kernels, as plain torch
(port of benor_tpu/ops/pallas_hist.py:58-187, 239-240).

    counter-based threefry2x32 bits -> uniforms -> AS241 normal quantile ->
    skew-corrected Cornish-Fisher hypergeometric draws

Every function here is the plain version of a ``__device__`` twin in
csrc/stream.cuh; the two are written op for op alike, so the kernels
(built with ``-fmad=false``) round exactly as these torch ops do on the
card.  Threefry runs on int64 tensors masked to 32 bits (torch's uint32
coverage is partial and ``>>`` on int32 is arithmetic); the same function
takes Python ints, which is how the per-round stream keys are derived on
the host.
"""

from __future__ import annotations

import torch

#: Node padding of the plane stack: the pack pads N up to a multiple of
#: this, as the JAX package does, so the two packs compare word for word.
TILE_N = 512

#: Key-derivation counter words: the sampler streams use the raw phase tag
#: (0 / 1), the equivocate sampler phase + 64, the coin stream 255.
_COIN_SALT = 255
_EQUIV_SALT_OFFSET = 64

_M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def key_words(seed: int) -> tuple[int, int]:
    """The two key words ``jax.random.key_data(jax.random.key(seed))`` holds
    for a threefry key: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _M32


def _rotl(x, d: int):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 on 32-bit values held in int64 tensors (or Python
    ints) -> the two output words, each in [0, 2**32)."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for group in range(5):
        rots = _ROT_A if group % 2 == 0 else _ROT_B
        for d in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + keys[(group + 1) % 3]) & _M32
        x1 = (x1 + keys[(group + 2) % 3] + group + 1) & _M32
    return x0, x1


def stream_scal(seed: int, r: int, salt: int) -> tuple[int, int]:
    """The (k0, k1) key of one stream: one scalar threefry of the run's key
    words with counter (round, salt) — the first two words of the JAX
    package's ``_stream_scal`` (the other two are mesh offsets, 0 on one
    device)."""
    kd0, kd1 = key_words(seed)
    return threefry2x32(kd0, kd1, int(r) & _M32, salt & _M32)


def lane_ids(trials: int, n_nodes: int, device):
    """GLOBAL (node, trial) counters int64 [1, N] and [T, 1] — broadcast
    together they give every lane a unique counter pair, independent of
    how a kernel tiles the lanes."""
    node = torch.arange(n_nodes, dtype=torch.int64, device=device)[None, :]
    trial = torch.arange(trials, dtype=torch.int64, device=device)[:, None]
    return node, trial


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> f32 uniform in (0, 1): splice the top 23 bits
    into a [1, 2) mantissa, subtract 1, clip to [1e-7, 1 - 1e-7]."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = word.view(torch.float32) - 1.0
    return torch.clamp(f, 1e-7, 1.0 - 1e-7)


def ndtri_as241(p: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF, Wichura AS241 PPND7, f32 op for op."""
    q = p - 0.5
    r_c = 0.180625 - q * q
    num_c = ((((5.9109374720e+01 * r_c + 1.5929113202e+02) * r_c +
               5.0434271938e+01) * r_c + 3.3871327179e+00))
    den_c = ((((6.7187563600e+01 * r_c + 7.8757757664e+01) * r_c +
               1.7895169469e+01) * r_c + 1.0))
    central = q * num_c / den_c

    r_t = torch.sqrt(-torch.log(torch.minimum(p, 1.0 - p)))
    r_m = r_t - 1.6
    num_m = ((((1.7023821103e-01 * r_m + 1.3067284816e+00) * r_m +
               2.7568153900e+00) * r_m + 1.4234372777e+00))
    den_m = (1.2021132975e-01 * r_m + 7.3700164250e-01) * r_m + 1.0
    r_f = r_t - 5.0
    num_f = ((((1.7337203997e-02 * r_f + 4.2868294337e-01) * r_f +
               3.0812263860e+00) * r_f + 6.6579051150e+00))
    den_f = (1.2258202635e-02 * r_f + 2.4197894225e-01) * r_f + 1.0
    tail = torch.where(r_t <= 5.0, num_m / den_m, num_f / den_f)
    tail = torch.where(q < 0.0, -tail, tail)

    return torch.where(torch.abs(q) <= 0.425, central, tail)


def cf_draw(u: torch.Tensor, total: torch.Tensor, good: torch.Tensor,
            nsample) -> torch.Tensor:
    """Skew-corrected (Cornish-Fisher) hypergeometric quantile draw of
    ``nsample`` from a population ``total`` with ``good`` successes, f32,
    clamped to the support.  ``nsample`` is a tensor or a Python number
    (the quorum, exact in f32)."""
    if not torch.is_tensor(nsample):
        nsample = torch.tensor(nsample, dtype=torch.float32,
                               device=u.device)
    t = torch.clamp_min(total, 1.0)
    g = good
    n = nsample
    p = g / t
    mean = n * p
    fpc = torch.where(t > 1.0, (t - n) / torch.clamp_min(t - 1.0, 1.0), 0.0)
    var = torch.clamp_min(n * p * (1.0 - p) * fpc, 0.0)
    z = ndtri_as241(u)
    denom = torch.sqrt(torch.clamp_min(n * g * (t - g) * (t - n), 1.0)) * \
        torch.clamp_min(t - 2.0, 1.0)
    skew = (t - 2.0 * g) * torch.sqrt(torch.clamp_min(t - 1.0, 0.0)) * \
        (t - 2.0 * n) / denom
    z = z + (z * z - 1.0) * skew / 6.0
    draw = torch.round(mean + z * torch.sqrt(var))
    lo = torch.clamp_min(n - (t - g), 0.0)
    hi = torch.minimum(g, n)
    return torch.minimum(torch.maximum(draw, lo), hi)


def cf_pair_draws(m, key, hist_f: torch.Tensor, shape, device):
    """The per-lane CF tally pair (csrc/stream.cuh ``cf_pair_draws``): one
    threefry block per lane gives both uniforms; p0 ~ CF(total, c0, m),
    p1 | p0 ~ CF(total - c0, c1, m - p0).  ``hist_f`` is the f32 [T, 3]
    class histogram; ``shape`` the lanes' (T, N)."""
    node, trial = lane_ids(shape[0], shape[1], device)
    b0, b1 = threefry2x32(key[0], key[1], node, trial)
    u0 = bits_to_uniform(b0)
    u1 = bits_to_uniform(b1)
    c0, c1, cq = hist_f[:, 0:1], hist_f[:, 1:2], hist_f[:, 2:3]
    total = c0 + c1 + cq
    mf = torch.tensor(float(m), dtype=torch.float32, device=device)
    p0 = cf_draw(u0, total, c0, mf)
    p1 = cf_draw(u1, torch.clamp_min(total - c0, 0.0), c1,
                 torch.clamp_min(mf - p0, 0.0))
    return p0, p1
