"""The shared device math of the round kernels, as plain torch
(port of benor_tpu/ops/pallas_hist.py:58-187, 239-240).

    counter-based threefry2x32 bits -> uniforms -> AS241 normal quantile ->
    skew-corrected Cornish-Fisher hypergeometric draws (split into
    per-trial and per-lane terms, as the kernels compute them)

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


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 on 32-bit values held in int64 tensors (or Python
    ints) -> the two output words, each in [0, 2**32).

    Only ``x0``'s low 32 bits ever reach ``x1`` (through the xor, which is
    masked), so ``x0`` is carried unmasked and masked once at the end: it
    grows by less than 2**32 an addition, 26 additions from below 2**33,
    so it stays below 2**38 in int64.  The words equal the masked-every-
    step form exactly; the tensor path runs one op fewer a mix."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)
    x0 = x0 + k0
    x1 = (x1 + k1) & _M32
    for group in range(5):
        rots = _ROT_A if group % 2 == 0 else _ROT_B
        for d in rots:
            x0 = x0 + x1
            x1 = ((x1 << d) | (x1 >> (32 - d))) ^ x0
            x1 &= _M32
        x0 = x0 + keys[(group + 1) % 3]
        x1 = (x1 + (keys[(group + 2) % 3] + group + 1)) & _M32
    return x0 & _M32, x1


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


def ndtri_clipped(p: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF, Wichura AS241 PPND7, f32 op for op, for the p
    that ``bits_to_uniform`` returns: its clip to [1e-7, 1 - 1e-7] keeps
    sqrt(-log(min(p, 1 - p))) <= 4.02, so AS241's far tail (r_t > 5) is
    never selected and is left out; the numerator and denominator are
    selected before one divide."""
    q = p - 0.5
    r_c = 0.180625 - q * q
    num_c = ((((5.9109374720e+01 * r_c + 1.5929113202e+02) * r_c +
               5.0434271938e+01) * r_c + 3.3871327179e+00))
    den_c = ((((6.7187563600e+01 * r_c + 7.8757757664e+01) * r_c +
               1.7895169469e+01) * r_c + 1.0))
    r_t = torch.sqrt(-torch.log(torch.minimum(p, 1.0 - p)))
    r_m = r_t - 1.6
    num_m = ((((1.7023821103e-01 * r_m + 1.3067284816e+00) * r_m +
               2.7568153900e+00) * r_m + 1.4234372777e+00))
    den_m = (1.2021132975e-01 * r_m + 7.3700164250e-01) * r_m + 1.0
    central = torch.abs(q) <= 0.425
    num = torch.where(central, q * num_c,
                      torch.where(q < 0.0, -num_m, num_m))
    return num / torch.where(central, den_c, den_m)


# The skew-corrected (Cornish-Fisher) hypergeometric quantile draw, in the
# three parts of csrc/stream.cuh (cf_pop, cf_terms, cf_sample): the
# population's terms, the sample size's terms, the lane's remainder.  On
# [T, 1] operands torch computes the first two once per trial, as the
# kernels do.


def cf_pop(total: torch.Tensor, good: torch.Tensor) -> dict:
    """The terms of a draw that depend only on its population."""
    t = torch.clamp_min(total, 1.0)
    g = good
    p = g / t
    return dict(t=t, g=g, p=p, omp=1.0 - p,
                tm1=torch.clamp_min(t - 1.0, 1.0), t_gt1=t > 1.0,
                tm2=torch.clamp_min(t - 2.0, 1.0), tmg=t - g,
                a=(t - 2.0 * g) * torch.sqrt(torch.clamp_min(t - 1.0, 0.0)))


def cf_terms(c: dict, n: torch.Tensor) -> dict:
    """The terms of a draw of ``n`` from the population ``c``."""
    t = c["t"]
    mean = n * c["p"]
    tmn = t - n
    fpc = torch.where(c["t_gt1"], tmn / c["tm1"], 0.0)
    sd = torch.sqrt(torch.clamp_min(mean * c["omp"] * fpc, 0.0))
    denom = torch.sqrt(torch.clamp_min(n * c["g"] * c["tmg"] * tmn, 1.0)) \
        * c["tm2"]
    return dict(mean=mean, sd=sd, skew=c["a"] * (t - 2.0 * n) / denom,
                lo=torch.clamp_min(n - c["tmg"], 0.0),
                hi=torch.minimum(c["g"], n))


def cf_sample(u: torch.Tensor, d: dict) -> torch.Tensor:
    """A lane's draw from its uniform and its draw's terms."""
    z = ndtri_clipped(u)
    z = z + (z * z - 1.0) * d["skew"] / 6.0
    return torch.minimum(torch.maximum(torch.round(d["mean"] + z * d["sd"]),
                                       d["lo"]), d["hi"])


def cf_draw(u: torch.Tensor, total: torch.Tensor, good: torch.Tensor,
            nsample) -> torch.Tensor:
    """Draw of ``nsample`` from a population ``total`` with ``good``
    successes, f32, clamped to the support.  ``nsample`` is a tensor or a
    Python number (the quorum, exact in f32)."""
    if not torch.is_tensor(nsample):
        nsample = torch.tensor(nsample, dtype=torch.float32,
                               device=u.device)
    return cf_sample(u, cf_terms(cf_pop(total, good), nsample))


def cf_pair_draws(m, key, hist_f: torch.Tensor, shape, device):
    """The per-lane CF tally pair (csrc/stream.cuh ``cf_trial`` +
    ``cf_pair``): one threefry block per lane gives both uniforms;
    p0 ~ CF(total, c0, m), p1 | p0 ~ CF(total - c0, c1, m - p0).
    ``hist_f`` is the f32 [T, 3] class histogram; ``shape`` the lanes'
    (T, N)."""
    node, trial = lane_ids(shape[0], shape[1], device)
    b0, b1 = threefry2x32(key[0], key[1], node, trial)
    u0 = bits_to_uniform(b0)
    u1 = bits_to_uniform(b1)
    c0, c1, cq = hist_f[:, 0:1], hist_f[:, 1:2], hist_f[:, 2:3]
    total = c0 + c1 + cq
    mf = torch.full_like(c0, float(m))
    p0 = cf_sample(u0, cf_terms(cf_pop(total, c0), mf))
    p1 = cf_sample(u1, cf_terms(cf_pop(torch.clamp_min(total - c0, 0.0), c1),
                                torch.clamp_min(mf - p0, 0.0)))
    return p0, p1


def equiv_trial(hist_f: torch.Tensor, ne_f: torch.Tensor, m) -> dict:
    """The per-trial terms of the equivocate tally (csrc/stream.cuh
    ``equiv_trial``) from the f32 [T, 3] honest histogram and the f32 [T]
    live equivocators: h_b's terms at the quorum ``m`` and the populations
    of h0 and h1, each [T, 1]."""
    c0, c1, cq = hist_f[:, 0:1], hist_f[:, 1:2], hist_f[:, 2:3]
    ne = ne_f[:, None]
    total_h = c0 + c1 + cq
    total = total_h + ne
    mf = torch.full_like(c0, float(m))
    return dict(db=cf_terms(cf_pop(total, ne), mf), pop0=cf_pop(total_h, c0),
                pop1=cf_pop(torch.clamp_min(total_h - c0, 0.0), c1), m=mf)


def equiv_pair_draws(m, key, key2, hist_f: torch.Tensor, ne_f: torch.Tensor,
                     shape, device):
    """The per-lane equivocate tally (csrc/stream.cuh ``equiv_trial`` +
    ``equiv_draws``): the phase key's threefry block gives u0 and u1, the
    second key's (phase + 64) u_b and u_s, on the lanes' global counters
    -> the class-0, class-1 and "?" counts, f32 [T, N] each.  ``hist_f``:
    the f32 [T, 3] honest histogram; ``ne_f``: the f32 [T] live
    equivocators; ``shape``: the lanes' (T, N)."""
    node, trial = lane_ids(shape[0], shape[1], device)
    b0, b1 = threefry2x32(key[0], key[1], node, trial)
    b2, b3 = threefry2x32(key2[0], key2[1], node, trial)
    return equiv_draws(equiv_trial(hist_f, ne_f, m),
                       *(bits_to_uniform(b) for b in (b0, b1, b2, b3)))


def equiv_draws(e: dict, u0, u1, u_b, u_s):
    """A lane's equivocate tally (csrc/stream.cuh ``equiv_draws``) from its
    trial's terms and its four uniforms -> the class-0, class-1 and "?"
    counts it receives (f32): h_b delivered equivocators, the honest split
    of the rest, a Binomial(h_b, 1/2) class split of the h_b."""
    h_b = cf_sample(u_b, e["db"])
    rem = torch.clamp_min(e["m"] - h_b, 0.0)
    h0 = cf_sample(u0, cf_terms(e["pop0"], rem))
    h1 = cf_sample(u1, cf_terms(e["pop1"], torch.clamp_min(rem - h0, 0.0)))
    hq = torch.clamp_min(rem - h0 - h1, 0.0)
    z = ndtri_clipped(u_s)
    bs = torch.round(h_b * 0.5 + z * torch.sqrt(h_b) * 0.5)
    bs = torch.minimum(torch.clamp_min(bs, 0.0), h_b)
    return h0 + (h_b - bs), h1 + bs, hq
