"""Binomial samplers and the regime boundary (counterpart of
benor_tpu/ops/sampling.py:42-67, 212-254).

``EXACT_TABLE_MAX`` is the JAX package's boundary: quorums up to it take the
exact inverse-CDF tables there, larger ones the Cornish-Fisher draws the
port's kernels implement; on the ``delivery='all'`` path the same bound
picks the equivocator split's sampler.  Tests lower it (in both packages)
to force the other regime at small N; callers read it at call time.

``binomial_half`` and ``binomial_half_exact_shared`` are the
``delivery='all'`` equivocator split, with the f32 math the JAX functions
do, op for op: ``ndtri`` is the Cephes quantile of JAX's Python source
(jax/_src/scipy/special.py ``_ndtri``) with its coefficients written in,
and the shared table's log-pmf, normalisation and prefix sum follow
``_log_comb``.  Neither is bit-exact against XLA:CPU, whose ``log``,
``exp``, ``sqrt`` and ``gammaln`` (here ``torch.lgamma``) round
differently: the quantile differs by a few ulps on ~19 % of inputs,
which rarely moves a rounded draw, and the table's draws differ on a
fraction that grows with the equivocator count — none at n <= 8 on the
tests' sizes, ~0.5 % at n = 4096 (ROADMAP "Known differences";
tests/test_torch_all_delivery.py bounds both).
"""

from __future__ import annotations

import math

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


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to f32, as a 0-dim tensor on ``like``'s device."""
    return torch.tensor(v, dtype=_F32, device=like.device)


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
    logpmf = torch.where(torch.isfinite(logpmf), logpmf,
                         _c(-math.inf, logpmf))
    mx = logpmf.max(dim=-1, keepdim=True).values
    pmf = torch.exp(logpmf - torch.where(torch.isfinite(mx), mx,
                                         _c(0.0, mx)))
    pmf = pmf / torch.clamp(pmf.sum(dim=-1, keepdim=True), min=1e-30)
    cdf = torch.cumsum(pmf, dim=-1).to(u.device)
    idx = torch.searchsorted(cdf, u.contiguous(), right=False)
    return torch.minimum(torch.clamp(idx, 0, n_max),
                         n[:, None].to(idx.dtype)).to(torch.int32)
