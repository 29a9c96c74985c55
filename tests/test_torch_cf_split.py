"""The split CF draw (benor_tpu_torch/ops/stream.py ``cf_pop`` /
``cf_terms`` / ``cf_sample`` and ``cf_pair_draws``, the plain twins of
csrc/stream.cuh, which every CF kernel runs) against the whole draw as
pallas_hist.py ``_cf_draw`` writes it (with AS241's far tail), kept here
as the reference: bit for bit on random histograms at N = 1M magnitudes
and on edge histograms; the clipped normal quantile never needs the far
tail for any uniform ``bits_to_uniform`` returns; and a few edge cases
against the JAX package's ``_cf_draw``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu.ops import pallas_hist as jh
from benor_tpu_torch.ops import stream as ts

KEY = ts.stream_scal(0, 3, 1)

# (c0, c1, cq) and the quorum m of one trial
EDGES = {
    "total_0": ((0, 0, 0), 750_000),
    "total_1": ((1, 0, 0), 1),
    "total_1_c1": ((0, 1, 0), 1),
    "c0_0": ((0, 600_000, 400_000), 750_000),
    "c0_total": ((1_000_000, 0, 0), 750_000),
    "all_q": ((0, 0, 1_000_000), 750_000),
    "m_above_total": ((3_000, 2_000, 1_000), 750_000),
    "m_minus_p0_le_0": ((999_990, 5, 5), 600_000),
    "balanced": ((500_000, 500_000, 0), 750_000),
}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _same_bits(a, b):
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ndtri_whole(p):
    """AS241 PPND7 with all three branches, f32 op for op."""
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


def _cf_draw_whole(u, total, good, n):
    """pallas_hist.py _cf_draw as one expression, f32 op for op."""
    t = torch.clamp_min(total, 1.0)
    g = good
    p = g / t
    mean = n * p
    fpc = torch.where(t > 1.0, (t - n) / torch.clamp_min(t - 1.0, 1.0), 0.0)
    var = torch.clamp_min(n * p * (1.0 - p) * fpc, 0.0)
    z = _ndtri_whole(u)
    denom = torch.sqrt(torch.clamp_min(n * g * (t - g) * (t - n), 1.0)) * \
        torch.clamp_min(t - 2.0, 1.0)
    skew = (t - 2.0 * g) * torch.sqrt(torch.clamp_min(t - 1.0, 0.0)) * \
        (t - 2.0 * n) / denom
    z = z + (z * z - 1.0) * skew / 6.0
    draw = torch.round(mean + z * torch.sqrt(var))
    lo = torch.clamp_min(n - (t - g), 0.0)
    hi = torch.minimum(g, n)
    return torch.minimum(torch.maximum(draw, lo), hi)


def _split_vs_whole(hist, m, n_lanes):
    hist_f = torch.tensor(hist, dtype=torch.float32)
    shape = (hist_f.shape[0], n_lanes)
    split = ts.cf_pair_draws(m, KEY, hist_f, shape, "cpu")
    node, trial = ts.lane_ids(shape[0], shape[1], "cpu")
    b0, b1 = ts.threefry2x32(KEY[0], KEY[1], node, trial)
    c0, c1, cq = hist_f[:, 0:1], hist_f[:, 1:2], hist_f[:, 2:3]
    total = c0 + c1 + cq
    mf = torch.tensor(float(m))
    p0 = _cf_draw_whole(ts.bits_to_uniform(b0), total, c0, mf)
    p1 = _cf_draw_whole(ts.bits_to_uniform(b1),
                        torch.clamp_min(total - c0, 0.0), c1,
                        torch.clamp_min(mf - p0, 0.0))
    for a, b in zip((p0, p1), split):
        _same_bits(a, b)
    return split


@pytest.mark.parametrize("case", sorted(EDGES))
def test_split_equals_whole_on_edge_histograms(case):
    hist, m = EDGES[case]
    p0, p1 = _split_vs_whole([hist], m, 1 << 14)
    if case == "m_minus_p0_le_0":      # the second draw's sample is empty
        assert bool((p0 >= m).any())


@pytest.mark.parametrize("m", [550_000, 750_000, 800_000])
def test_split_equals_whole_on_random_histograms(m):
    rng = np.random.default_rng(m)
    hist = rng.multinomial(1_000_000, [0.45, 0.45, 0.1], size=16)
    hist[:4] = rng.integers(0, 1_000_000, size=(4, 3))  # totals up to 3M
    _split_vs_whole(hist.astype(np.float32), m, 1 << 15)


def test_ndtri_never_selects_the_far_tail():
    """Every uniform bits_to_uniform can return (2**23 values: its top 23
    bits, then the clip) has r_t <= 5, and there ndtri_clipped equals
    the three-branch AS241 bit for bit; both extreme bit patterns are
    among them."""
    worst = 0.0
    for lo in range(0, 1 << 23, 1 << 21):
        bits = (torch.arange(lo, lo + (1 << 21), dtype=torch.int64) << 9)
        if lo == 0:
            bits = torch.cat([bits, torch.tensor([0xFFFFFFFF])])
        u = ts.bits_to_uniform(bits)
        r_t = torch.sqrt(-torch.log(torch.minimum(u, 1.0 - u)))
        worst = max(worst, float(r_t.max()))
        _same_bits(ts.ndtri_clipped(u), _ndtri_whole(u))
    assert 4.0 < worst <= 4.02


@jax.jit
def _jax_pair(u0, u1, c0, c1, cq, m):
    total = c0 + c1 + cq
    p0 = jh._cf_draw(u0, total, c0, m)
    p1 = jh._cf_draw(u1, jnp.maximum(total - c0, 0.0), c1,
                     jnp.maximum(m - p0, 0.0))
    return p0, p1


def test_split_equals_jax_cf_draw_on_small_edge_histograms():
    """Populations up to 4096, where the JAX and torch normal quantiles
    give the same draws: total 0 and 1, c0 = 0, c0 = total, all "?",
    m above the total, m - p0 <= 0, and an ordinary case."""
    hist = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 96, 40],
                     [96, 0, 0], [0, 0, 96], [30, 20, 10], [4093, 2, 1],
                     [2048, 1800, 248]], dtype=np.float32)
    m = np.array([72, 1, 1, 72, 72, 72, 100, 3000, 3000], np.float32)
    n_lanes = 1 << 12
    bits = np.random.default_rng(5).integers(0, 1 << 32, (2, len(hist),
                                                          n_lanes))
    u0, u1 = (ts.bits_to_uniform(torch.from_numpy(b)) for b in bits)
    h = torch.from_numpy(hist)
    c0, c1 = h[:, :1], h[:, 1:2]
    total = c0 + c1 + h[:, 2:3]
    mt = torch.from_numpy(m)[:, None]
    p0 = ts.cf_sample(u0, ts.cf_terms(ts.cf_pop(total, c0), mt))
    p1 = ts.cf_sample(u1, ts.cf_terms(
        ts.cf_pop(torch.clamp_min(total - c0, 0.0), c1),
        torch.clamp_min(mt - p0, 0.0)))
    j0, j1 = _jax_pair(u0.numpy(), u1.numpy(), hist[:, :1], hist[:, 1:2],
                       hist[:, 2:3], m[:, None])
    np.testing.assert_array_equal(p0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(j1))
    assert bool((p0[7] >= m[7]).any())          # m - p0 <= 0 in some lane
