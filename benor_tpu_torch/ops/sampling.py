"""The quorum-count samplers and the regime boundary (port of
benor_tpu/ops/sampling.py).

``EXACT_TABLE_MAX`` is the JAX package's boundary: quorums up to it take the
exact inverse-CDF tables (``hypergeom_exact_shared``: one [T, m + 1] CDF
table a trial, searched by every lane), larger ones the Cornish-Fisher
draws (``hypergeom_normal_approx`` with ``skew_correct``), both in plain
torch here and in the port's kernels (ops/hist.py) where the fused
samplers serve; on the ``delivery='all'`` path the same bound picks the
equivocator split's sampler.  Tests lower it (in both packages) to force
the other regime at small N; callers read it at call time.

The histogram path's plain samplers are the JAX functions op for op in
f32: the uniform scheduler's two-class draw
(``multivariate_hypergeom_counts``), its mixed-population twin under
equivocation (``equivocate_hypergeom_counts``), the biased scheduler's
two-population delay race (``uniform_race_favored_count``) and the
omission thinning draw (``binomial_keep``).  The CDF tables are built on
the host (per-trial data), so a card run and a CPU run search the same
table; ``shared_table_search`` is the device-side search alone.  The
tables are not bit-exact against XLA:CPU's (``torch.lgamma`` against
``gammaln``, ROADMAP "Known differences"); their search, handed XLA's
table, is.

``binomial_half`` and ``binomial_half_exact_shared`` are the
``delivery='all'`` equivocator split, with the f32 math the JAX functions
do, op for op: ``ndtri`` is the Cephes quantile of JAX's Python source
(jax/_src/scipy/special.py ``_ndtri``) with its coefficients written in,
and the shared table's log-pmf, normalisation and prefix sum follow
``_log_comb``.  Neither is bit-exact against XLA:CPU, which contracts
``a * b + c`` into a fused multiply-add inside a fusion (the Horner steps
among them) and whose ``log``, ``exp``, ``sqrt`` and ``gammaln`` (here
``torch.lgamma``) round differently: the quantile differs by a few ulps on ~19 % of inputs,
which rarely moves a rounded draw, and the table's draws differ on a
fraction that grows with the equivocator count — none at n <= 8 on the
tests' sizes, ~0.5 % at n = 4096 (ROADMAP "Known differences";
tests/test_torch_all_delivery.py bounds both).
"""

from __future__ import annotations

import math
import numbers

import torch

EXACT_TABLE_MAX = 4096

_F32 = torch.float32

# Cephes ndtri's rational approximations (jax/_src/scipy/special.py, _ndtri)
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number, or a tensor such as a ``DynParams`` field) rounded
    to f32, as a tensor on ``like``'s device."""
    return torch.as_tensor(v, dtype=_F32, device=like.device)


def _m_lanes(m, like: torch.Tensor) -> torch.Tensor:
    """The draw count ``m`` (an int, or an int32 0-dim tensor) as an int32
    tensor of ``like``'s shape."""
    return torch.as_tensor(m, dtype=torch.int32,
                           device=like.device).expand(like.shape)


def _polyval(coefs, x: torch.Tensor) -> torch.Tensor:
    """``jnp.polyval``: Horner from y = 0, one multiply and one add a
    coefficient, each rounded to f32."""
    y = torch.zeros_like(x)
    for c in coefs:
        y = y * x + _c(c, x)
    return y


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """The standard normal quantile of f32 ``p`` — ``jax.scipy.special.ndtri``
    (Cephes), op for op."""
    one, half = _c(1.0, p), _c(0.5, p)
    maybe_comp = torch.where(p > _c(-math.expm1(-2.0), p), one - p, p)
    sanitized = torch.where(maybe_comp == 0, half, maybe_comp)

    # p > exp(-2): x / sqrt(2 pi) = w + w**3 P0(w**2) / Q0(w**2)
    w = sanitized - half
    ww = w * w
    x_big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    x_big = x_big * _c(-math.sqrt(2.0 * math.pi), p)

    # p <= exp(-2): x = z - log(z) / z - (1 / z) P(1 / z) / Q(1 / z)
    z = torch.sqrt(_c(-2.0, p) * torch.log(sanitized))
    first = z - torch.log(z) / z
    inv_z = one / z
    small = _polyval(_P2, inv_z) / _polyval(_Q2, inv_z) / z
    other = _polyval(_P1, inv_z) / _polyval(_Q1, inv_z) / z
    x = torch.where(sanitized > _c(math.exp(-2.0), p), x_big,
                    torch.where(z >= _c(8.0, p), first - small,
                                first - other))
    x = torch.where(p > _c(1.0 - math.exp(-2.0), p), x, -x)
    inf = _c(math.inf, p)
    return torch.where(p == 0, -inf, torch.where(p == 1, inf, x))


def binomial_half(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Binomial(n, 1/2) draws by the normal quantile, per lane -> int32.

    ``u``: f32 uniforms; ``n``: int counts broadcastable to ``u``.  The
    symmetric binomial needs no skew term; the rounded quantile is ~4 %
    biased on the extreme counts at n ~ 2-10, so a per-trial n within
    ``EXACT_TABLE_MAX`` takes ``binomial_half_exact_shared``."""
    nf = n.to(_F32)
    z = ndtri(torch.clamp(u, _c(1e-7, u), _c(1 - 1e-7, u)))
    half = _c(0.5, u)
    draw = torch.round(nf * half + z * torch.sqrt(nf) * half)
    return torch.minimum(torch.clamp(draw, min=0.0), nf).to(torch.int32)


def _log_comb(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """log C(n, k) in f32, -inf outside 0 <= k <= n (sampling.py:60-67)."""
    n = n.to(_F32)
    k = k.to(_F32)
    valid = (k >= 0) & (k <= n)
    k_safe = torch.minimum(torch.clamp(k, min=0.0),
                           torch.clamp(n, min=0.0))
    one = _c(1.0, n)
    out = (torch.lgamma(n + one) - torch.lgamma(k_safe + one)
           - torch.lgamma(n - k_safe + one))
    return torch.where(valid, out, _c(-math.inf, n))


def binomial_half_exact_shared(u: torch.Tensor, n: torch.Tensor,
                               n_max: int) -> torch.Tensor:
    """Exact Binomial(n, 1/2) draws from a per-trial count shared by every
    lane of the trial -> int32 [T, N].

    ``u``: f32 uniforms [T, N]; ``n``: int counts [T], each <= ``n_max``.
    One [T, n_max + 1] CDF table a trial, searched by every lane (the
    first entry >= u, ``jnp.searchsorted``'s left side).  The table is
    built on the host whatever device ``u`` lives on: it is per-trial data
    (T x (n_max + 1) floats), and its f32 rounding is then the same for a
    card run and a CPU run, which therefore agree bit for bit."""
    n_host = n.detach().to("cpu", torch.int32)
    t = n_host.shape[0]
    k = torch.arange(n_max + 1, dtype=torch.int32)
    nf = n_host[:, None]
    logpmf = _log_comb(nf.expand(t, n_max + 1), k[None, :].expand(t, -1))
    logpmf = logpmf - nf.to(_F32) * _c(math.log(2.0), logpmf)
    return torch.minimum(shared_table_search(_cdf(logpmf), u, n_max),
                         n[:, None].to(torch.int32))


def _cdf(logpmf: torch.Tensor) -> torch.Tensor:
    """The prefix sum of a log-pmf's rows, each normalised by its max and
    its sum (non-finite entries count as -inf), as the JAX tables do."""
    logpmf = torch.where(torch.isfinite(logpmf), logpmf,
                         _c(-math.inf, logpmf))
    mx = logpmf.max(dim=-1, keepdim=True).values
    pmf = torch.exp(logpmf - torch.where(torch.isfinite(mx), mx,
                                         _c(0.0, mx)))
    pmf = pmf / torch.clamp(pmf.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.cumsum(pmf, dim=-1)


def static_m(m) -> int | None:
    """The Python value of a draw count, or None when it is not a Python
    (or numpy) integer: the exact shared-CDF samplers build [T, m + 1]
    tables and need a static m; anything else takes the CF branch."""
    if isinstance(m, numbers.Integral) and not isinstance(m, bool):
        return int(m)
    return None


def hypergeom_cdf_table(total: torch.Tensor, good: torch.Tensor,
                        m: int) -> torch.Tensor:
    """CDF of Hypergeometric(total, good, m) over h = 0..m -> f32
    [T, m + 1] on the host (sampling.py:70-85).

    ``total`` / ``good``: int [T].  Log-space pmf normalised by its max
    and its sum, then the prefix sum, with the JAX function's f32 ops; the
    table is per-trial data, so it is built on the CPU whatever device the
    lanes live on."""
    total = total.detach().to("cpu", torch.int32)
    good = good.detach().to("cpu", torch.int32)
    h = torch.arange(m + 1, dtype=torch.int32)
    shape = tuple(total.shape) + (m + 1,)
    t = total[..., None].expand(shape)
    g = good[..., None].expand(shape)
    return _cdf(_log_comb(g, h) + _log_comb(t - g, m - h)
                - _log_comb(t, torch.full_like(h, m)))


def shared_table_search(cdf: torch.Tensor, u: torch.Tensor,
                        m: int) -> torch.Tensor:
    """Each lane's draw from its trial's CDF row -> int32 [T, N]: the first
    entry >= u (``jnp.searchsorted``'s left side), clipped to 0..m.
    ``cdf``: f32 [T, m + 1] (moved to ``u``'s device); ``u``: f32
    [T, N]."""
    idx = torch.searchsorted(cdf.to(u.device).contiguous(), u.contiguous(),
                             right=False)
    return torch.clamp(idx, 0, m).to(torch.int32)


def hypergeom_exact_shared(u: torch.Tensor, total: torch.Tensor,
                           good: torch.Tensor, m: int) -> torch.Tensor:
    """Exact Hypergeometric(total, good, m) draws from per-trial
    parameters shared by every lane -> int32 [T, N] (sampling.py:88-98).
    ``u``: f32 [T, N]; ``total`` / ``good``: int [T]."""
    return shared_table_search(hypergeom_cdf_table(total, good, m), u, m)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), so hi wins where lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _quantile(u: torch.Tensor) -> torch.Tensor:
    """The standard normal quantile of the clipped uniform, as every
    sampler here takes it."""
    return ndtri(_clip(u, _c(1e-7, u), _c(1 - 1e-7, u)))


def hypergeom_normal_approx(u: torch.Tensor, total: torch.Tensor,
                            good: torch.Tensor, nsample: torch.Tensor,
                            skew_correct: bool = False) -> torch.Tensor:
    """Clamped normal-approximation Hypergeometric(total, good, nsample)
    draws, per lane -> int32 (sampling.py:101-129).

    ``u``: f32 uniforms; ``total`` / ``good`` / ``nsample``: ints
    broadcastable to ``u``.  ``skew_correct`` adds the second-order
    Cornish-Fisher term, ``z + (z*z - 1) * skew / 6`` in that order."""
    one = _c(1.0, u)
    t = torch.maximum(total.to(_F32), one)
    g = good.to(_F32)
    n = nsample.to(_F32)
    p = g / t
    mean = n * p
    zero = _c(0.0, u)
    fpc = torch.where(t > one, (t - n) / torch.maximum(t - one, one), zero)
    var = torch.maximum(n * p * (one - p) * fpc, zero)
    z = _quantile(u)
    if skew_correct:
        two = _c(2.0, u)
        denom = torch.sqrt(torch.maximum(n * g * (t - g) * (t - n), one)) \
            * torch.maximum(t - two, one)
        skew = (t - two * g) * torch.sqrt(torch.maximum(t - one, zero)) \
            * (t - two * n) / denom
        z = z + (z * z - one) * skew / _c(6.0, u)
    draw = torch.round(mean + z * torch.sqrt(var))
    lo = torch.maximum(zero, n - (t - g))
    hi = torch.minimum(g, n)
    return _clip(draw, lo, hi).to(torch.int32)


def uniform_race_favored_count(u: torch.Tensor, nf: torch.Tensor,
                               ns: torch.Tensor, m: int,
                               s: float) -> torch.Tensor:
    """#favored among the m smallest of a two-population uniform delay
    race -> int32 (sampling.py:132-185): favored delays ~ U[0, 1), starved
    ~ U[s, 1 + s); the mean-field threshold tau in three closed-form
    regimes, the delta-method variance at it, the clamped normal quantile.

    ``u``: f32 uniforms; ``nf`` / ``ns``: int populations broadcastable to
    ``u``; ``m``: the draw count; ``s``: the strength in (0, 1), rounded
    to f32 where it meets an f32 operand, and ``1 + s`` rounded from the
    double sum, as JAX's weak typing does."""
    nf_f = nf.to(_F32)
    ns_f = ns.to(_F32)
    m_f = _c(m, u)
    sf = _c(s, u)
    zero, one = _c(0.0, u), _c(1.0, u)
    eps = _c(1e-6, u)
    safe_nf = torch.maximum(nf_f, eps)
    safe_ns = torch.maximum(ns_f, eps)
    tau = m_f / safe_nf                                   # m <= nf*s
    tau2 = (m_f + ns_f * sf) / torch.maximum(nf_f + ns_f, eps)
    tau = torch.where(m_f > nf_f * sf, tau2, tau)         # competition
    tau3 = sf + (m_f - nf_f) / safe_ns
    tau = torch.where(tau2 > one, tau3, tau)              # favored gone
    ff = _clip(tau, zero, one)
    fs = _clip(tau - sf, zero, one)
    mu = nf_f * ff
    lam_f = nf_f * ((tau > zero) & (tau <= one)).to(_F32)
    lam_s = ns_f * ((tau > sf) & (tau <= _c(1.0 + s, u))).to(_F32)
    sig2_f = nf_f * ff * (one - ff)
    sig2_s = ns_f * fs * (one - fs)
    lam = lam_f + lam_s
    denom = torch.maximum(lam * lam, eps)
    var = (lam_s * lam_s * sig2_f + lam_f * lam_f * sig2_s) / denom
    z = _quantile(u)
    draw = torch.round(mu + z * torch.sqrt(var))
    hi = torch.minimum(nf_f, m_f)
    lo = torch.minimum(torch.maximum(zero, m_f - ns_f), hi)
    return _clip(draw, lo, hi).to(torch.int32)


def binomial_keep(u: torch.Tensor, n: torch.Tensor, keep) -> torch.Tensor:
    """Binomial(n, keep) by the clamped normal quantile -> int32: the
    omission thinning draw (sampling.py:188-209).  ``u``: f32 uniforms;
    ``n``: counts broadcastable to ``u``; ``keep``: the survival
    probability, an f32 0-dim tensor or a float (rounded to f32)."""
    zero, one = _c(0.0, u), _c(1.0, u)
    nf = torch.maximum(n.to(_F32), zero)
    q = torch.as_tensor(keep, dtype=_F32, device=u.device)
    q = _clip(q, zero, one)
    mean = nf * q
    var = torch.maximum(nf * q * (one - q), zero)
    z = _quantile(u)
    draw = torch.round(mean + z * torch.sqrt(var))
    return _clip(draw, zero, nf).to(torch.int32)


def equivocate_hypergeom_counts(u_b: torch.Tensor, u0: torch.Tensor,
                                u1: torch.Tensor, u_s: torch.Tensor,
                                honest_counts: torch.Tensor,
                                n_equiv: torch.Tensor, m: int) -> torch.Tensor:
    """Per-lane tallied counts when live equivocators hide among the
    senders -> int32 [T, N, 3] (sampling.py:256-308): how many
    equivocators the lane's quorum holds (the exact shared table in the
    exact regime, else the CF draw), the honest split of the rest, and the
    fair-bit split of the delivered equivocator messages.

    ``u_b`` / ``u0`` / ``u1`` / ``u_s``: f32 [T, N]; ``honest_counts``:
    int32 [T, 3]; ``n_equiv``: int32 [T]."""
    ms = static_m(m)
    c0 = honest_counts[:, 0]
    c1 = honest_counts[:, 1]
    total_h = honest_counts.sum(dim=-1, dtype=torch.int32)      # [T]
    total = total_h + n_equiv
    exact = ms is not None and ms <= EXACT_TABLE_MAX
    if exact:
        h_b = hypergeom_exact_shared(u_b, total, n_equiv, ms)
    else:
        h_b = hypergeom_normal_approx(
            u_b, total[:, None].expand(u_b.shape),
            n_equiv[:, None].expand(u_b.shape),
            _m_lanes(m, u_b),
            skew_correct=True)
    rem = torch.clamp(m - h_b, min=0)                           # honest
    h0 = hypergeom_normal_approx(
        u0, total_h[:, None].expand(u0.shape),
        c0[:, None].expand(u0.shape), rem, skew_correct=not exact)
    h1 = hypergeom_normal_approx(
        u1, torch.clamp(total_h[:, None] - c0[:, None], min=0), c1[:, None],
        torch.clamp(rem - h0, min=0), skew_correct=not exact)
    hq = torch.clamp(rem - h0 - h1, min=0)
    b1 = binomial_half(u_s, h_b)
    return torch.stack([h0 + (h_b - b1), h1 + b1, hq], dim=-1)


def multivariate_hypergeom_counts(u0: torch.Tensor, u1: torch.Tensor,
                                  class_counts: torch.Tensor,
                                  m: int) -> torch.Tensor:
    """Per-lane tallied class counts (h0, h1, hq) drawn without replacement
    -> int32 [T, N, 3] (sampling.py:311-338): h0 by the exact shared table
    in the exact regime, else the CF draw; h1 given h0 by the normal
    draw (CF above the exact regime).

    ``u0`` / ``u1``: f32 [T, N]; ``class_counts``: int32 [T, 3]; ``m``:
    the quorum."""
    ms = static_m(m)
    c0 = class_counts[:, 0]
    c1 = class_counts[:, 1]
    total = class_counts.sum(dim=-1, dtype=torch.int32)          # [T]
    exact = ms is not None and ms <= EXACT_TABLE_MAX
    if exact:
        h0 = hypergeom_exact_shared(u0, total, c0, ms)
    else:
        h0 = hypergeom_normal_approx(
            u0, total[:, None].expand(u0.shape), c0[:, None].expand(u0.shape),
            _m_lanes(m, u0),
            skew_correct=True)
    rem_total = torch.clamp(total[:, None] - c0[:, None], min=0)
    rem_draw = torch.clamp(m - h0, min=0)
    h1 = hypergeom_normal_approx(u1, rem_total, c1[:, None], rem_draw,
                                 skew_correct=not exact)
    hq = torch.clamp(m - h0 - h1, min=0)
    return torch.stack([h0, h1, hq], dim=-1)
