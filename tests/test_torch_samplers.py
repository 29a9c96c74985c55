"""The histogram path's plain samplers and the omission and partition
planes of benor_tpu_torch against the JAX package, function by function,
on the CPU.

Held exactly (``assert_array_equal``) on seeded numpy inputs: the normal
and Cornish-Fisher hypergeometric draws at populations up to 20,000 (the
sizes of the CPU runs and of the card-against-CPU runs), the biased
scheduler's delay race over the regime grid of tests/test_sampling.py,
the omission thinning draw, the two-class and mixed-population samplers
and the biased scheduler's strict and fractional forms in the CF regime,
the omission thinning of a receiver's counts, the partition's group counts
inside and after the epoch, and the partition grammar and SimConfig's
partition verdicts with every message of the JAX package's.  At
populations up to a million XLA:CPU's fused multiply-adds move a draw by
one count now and then: the draws there differ on at most twice the count
measured, by one.  The exact shared tables: the port's search handed JAX's
table equals JAX's draws exactly; the port's own table is held to JAX's
within the rounding of f32 ``lgamma`` (``torch.lgamma`` against XLA's
``gammaln``), and its draws differ from JAX's on at most twice the count
measured over 1.6M uniforms.  ``pytest -s`` prints every count.  The JAX
side runs under ``jax.jit`` on numpy inputs; its caches are dropped when
the module is done."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from benor_tpu.config import SimConfig as JCfg
from benor_tpu.faults import partitions as jpart
from benor_tpu.ops import sampling as jsampling
from benor_tpu.ops import tally as jtally
from benor_tpu_torch import SimConfig as TCfg
from benor_tpu_torch import faults as tfaults
from benor_tpu_torch.faults import partitions as tpart
from benor_tpu_torch.ops import rng as trng
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.ops import tally as ttally
from torch_ref_pool import prefetch, ref, start

J_NORMAL = jax.jit(jsampling.hypergeom_normal_approx, static_argnums=4)
J_RACE = jax.jit(jsampling.uniform_race_favored_count,
                 static_argnums=(3, 4))
J_KEEP = jax.jit(jsampling.binomial_keep)
J_TABLE = jax.jit(jsampling.hypergeom_cdf_table, static_argnums=2)
J_EXACT = jax.jit(jsampling.hypergeom_exact_shared, static_argnums=3)
J_OMISSION = jax.jit(jtally.omission_thin_counts)
J_PARTITION = jax.jit(jtally.partition_counts, static_argnums=(0, 1))

CF_MAX = 4                 # EXACT_TABLE_MAX in the CF-regime tests


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


@contextlib.contextmanager
def _table_max(value):
    """EXACT_TABLE_MAX set to ``value`` in BOTH packages, restored on
    exit."""
    old = jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = tsampling.EXACT_TABLE_MAX = value
    try:
        yield
    finally:
        jsampling.EXACT_TABLE_MAX, tsampling.EXACT_TABLE_MAX = old


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _hists(rs, t, total, m):
    """int32 [t, 3] class histograms summing to ``total``, with the corners
    a sampler clamps at: one class empty, one class everything, a
    population short of the quorum m."""
    rows = [(total, 0, 0), (0, total, 0), (0, 0, total),
            (m // 2, m // 2 - 1, 0), (total // 2, total - total // 2, 0)]
    while len(rows) < t:
        c0 = int(rs.integers(0, total + 1))
        c1 = int(rs.integers(0, total - c0 + 1))
        rows.append((c0, c1, total - c0 - c1))
    return np.array(rows[:t], np.int32)


# --- the per-lane draws -------------------------------------------------------


def _normal_case(seed, max_total):
    """Lane-varying (total, good, nsample) below ``max_total``, with empty
    populations, the draw count 0 and the whole population, and the
    uniform's corners."""
    rs = np.random.default_rng(seed)
    shape = (6, 4000)
    total = rs.integers(0, max_total, size=shape).astype(np.int32)
    total[0, :50] = rs.integers(0, 4, size=50)
    good = (rs.random(shape) * (total + 1)).astype(np.int32)
    good[1, :20], good[1, 20:40] = 0, total[1, 20:40]
    nsample = (rs.random(shape) * (total + 1)).astype(np.int32)
    nsample[2, :20], nsample[2, 20:40] = 0, total[2, 20:40]
    u = rs.random(shape, dtype=np.float32)
    u[3, :4] = (0.0, 1e-9, 1 - 1e-9, 0.5)
    return u, total, good, nsample


def _differing(got, want):
    """(draws that differ, largest difference)."""
    d = np.abs(got.astype(np.int64) - want)
    return int((d > 0).sum()), int(d.max())


@pytest.mark.parametrize("skew", [False, True], ids=["normal", "cf"])
def test_hypergeom_normal_approx_matches_jax(skew):
    """Populations up to 20,000 (the CPU runs' and the card-against-CPU
    runs' sizes): every draw equal.  Up to a million: XLA:CPU contracts
    ``a * b + c`` into one fused multiply-add where the port rounds twice,
    so a draw may move by one count; at most 2 of the 24,000 (1 and 0
    measured) differ, by one."""
    for max_total, bound in ((20_000, 0), (1_000_000, 2)):
        u, total, good, nsample = _normal_case(11, max_total)
        want = np.asarray(J_NORMAL(u, total, good, nsample, skew))
        got = tsampling.hypergeom_normal_approx(
            *_t(u, total, good, nsample), skew_correct=skew)
        assert got.dtype == torch.int32
        n_diff, worst = _differing(got.numpy(), want)
        print(f"hypergeom_normal_approx skew={skew} populations < "
              f"{max_total}: {n_diff} of {u.size} draws differ")
        assert n_diff <= bound and worst <= 1


# tests/test_sampling.py's regime grid (nf_val, nq, ns, m, s): every draw
# equal
@pytest.mark.parametrize("nf_val,nq,ns,m,s", [
    (30, 10, 40, 56, 0.5),    # competition window
    (20, 5, 55, 56, 0.25),    # weak bias
    (12, 4, 10, 20, 0.6),     # favored short of quorum (tau ~ 1)
    (10, 2, 68, 56, 0.75),    # favored exhausted (deterministic)
])
def test_uniform_race_favored_count_matches_jax(nf_val, nq, ns, m, s):
    rs = np.random.default_rng(nf_val)
    u = rs.random((2, 12_000), dtype=np.float32)
    nf = np.full(u.shape, nf_val + nq, np.int32)
    nsv = np.full(u.shape, ns, np.int32)
    # the second row varies the populations lane by lane around the point
    nf[1] = rs.integers(0, 2 * (nf_val + nq) + 1, size=u.shape[1])
    nsv[1] = rs.integers(0, 2 * ns + 1, size=u.shape[1])
    want = np.asarray(J_RACE(u, nf, nsv, m, s))
    got = tsampling.uniform_race_favored_count(*_t(u, nf, nsv), m, s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_race_favored_count_at_a_million():
    """bench.py's biased_s0.5 point at N = 1M (f = 0.25, balanced inputs:
    favored 750,000 of 1M, m = 750,000) and a strength whose 1 + s is not
    exact in f32, populations varied lane by lane: XLA:CPU's fused
    multiply-add in the threshold (``m + ns * s``) and the quantile moves a
    draw by one count now and then; at most 2x the count measured (17 of
    24,000 on the second point) differ, by one."""
    for nf0, ns0, m, s, bound in ((750_000, 250_000, 750_000, 0.5, 34),
                                  (400_000, 350_000, 562_500, 0.3, 34)):
        rs = np.random.default_rng(300_000)
        u = rs.random((2, 12_000), dtype=np.float32)
        nf = np.full(u.shape, nf0, np.int32)
        nsv = np.full(u.shape, ns0, np.int32)
        nf[1] = rs.integers(0, 2 * nf0 + 1, size=u.shape[1])
        nsv[1] = rs.integers(0, 2 * ns0 + 1, size=u.shape[1])
        want = np.asarray(J_RACE(u, nf, nsv, m, s))
        got = tsampling.uniform_race_favored_count(*_t(u, nf, nsv), m, s)
        n_diff, worst = _differing(got.numpy(), want)
        print(f"uniform_race_favored_count ({nf0}, {ns0}, {m}, {s}): "
              f"{n_diff} of {u.size} draws differ")
        assert n_diff <= bound and worst <= 1


@pytest.mark.parametrize("drop_p", [0.0, 0.05, 0.5, 0.9])
def test_binomial_keep_matches_jax(drop_p):
    """The thinning draw with keep = 1 - p rounded as the tally rounds it."""
    rs = np.random.default_rng(int(drop_p * 100))
    u = rs.random((4, 6000), dtype=np.float32)
    n = rs.integers(-2, 1_000_000, size=u.shape).astype(np.int32)
    n[0, :100] = rs.integers(0, 10, size=100)
    keep = np.float32(1.0) - np.float32(drop_p)
    want = np.asarray(J_KEEP(u, n, keep))
    got = tsampling.binomial_keep(*_t(u, n),
                                  torch.tensor(keep, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the count samplers in the CF regime --------------------------------------


def _mv_case(m):
    rs = np.random.default_rng(m)
    t, n = 8, 3000
    total = 2 * m
    hist = _hists(rs, t, total, m)
    n_equiv = rs.integers(0, m // 2 + 2, size=t).astype(np.int32)
    n_equiv[:2] = (0, m)
    u = [rs.random((t, n), dtype=np.float32) for _ in range(4)]
    return u, hist, n_equiv


def _jax_mv_counts(m):
    """JAX's two-class draw and its mixed-population twin with
    EXACT_TABLE_MAX = CF_MAX (``_jax_*``: a worker's calls, see
    torch_ref_pool)."""
    u, hist, n_equiv = _mv_case(m)
    with _table_max(CF_MAX):
        want_mv = np.asarray(jax.jit(
            jsampling.multivariate_hypergeom_counts, static_argnums=3)(
                u[0], u[1], hist, m))
        want_eq = np.asarray(jax.jit(
            jsampling.equivocate_hypergeom_counts, static_argnums=6)(
                *u, hist, n_equiv, m))
    return want_mv, want_eq


@pytest.mark.parametrize("m", [5, 56, 700])
@prefetch(lambda m: [(_jax_mv_counts, m)])
def test_multivariate_and_equivocate_counts_match_jax_in_cf_regime(m):
    """The uniform scheduler's two-class draw and its mixed-population twin
    under equivocation, quorum above the (lowered) table bound."""
    u, hist, n_equiv = _mv_case(m)
    want_mv, want_eq = ref(_jax_mv_counts, m)
    with _table_max(CF_MAX):
        got_mv = tsampling.multivariate_hypergeom_counts(
            *_t(u[0], u[1], hist), m)
        got_eq = tsampling.equivocate_hypergeom_counts(
            *_t(*u, hist, n_equiv), m)
    np.testing.assert_array_equal(got_mv.numpy(), want_mv)
    np.testing.assert_array_equal(got_eq.numpy(), want_eq)


def _biased_case(strength):
    rs = np.random.default_rng(int(strength * 8))
    t, n, m = 8, 3001, 72
    hist = _hists(rs, t, 96, m)
    u0, u1 = (rs.random((t, n), dtype=np.float32) for _ in range(2))
    return hist, u0, u1


def _jax_biased_counts(strength):
    hist, u0, u1 = _biased_case(strength)
    n, m = 3001, 72
    node_ids = np.arange(5, 5 + n, dtype=np.int32)
    with _table_max(CF_MAX):
        if strength >= 1.0:
            want = jax.jit(jtally.biased_priority_counts,
                           static_argnums=2)(u0, hist, m, node_ids)
        else:
            want = jax.jit(jtally.biased_fractional_counts,
                           static_argnums=(0, 4))(strength, u0, u1, hist, m,
                                                  node_ids)
    return np.asarray(want)


@pytest.mark.parametrize("strength", [0.25, 0.5, 0.9, 1.0, 1.5])
@prefetch(lambda strength: [(_jax_biased_counts, strength)])
def test_biased_counts_match_jax_in_cf_regime(strength):
    """biased_priority_counts (strength >= 1) and biased_fractional_counts
    (0 < s < 1) over histograms whose favored populations cover the quorum
    or fall short of it, even and odd receivers."""
    n, m = 3001, 72
    hist, u0, u1 = _biased_case(strength)
    want = ref(_jax_biased_counts, strength)
    with _table_max(CF_MAX):
        if strength >= 1.0:
            got = ttally.biased_priority_counts(*_t(u0, hist), m,
                                                torch.arange(5, 5 + n))
        else:
            got = ttally.biased_fractional_counts(
                strength, *_t(u0, u1, hist), m, torch.arange(5, 5 + n))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) <= m).all()


# --- the omission and partition planes ---------------------------------------


def _omission_case():
    rs = np.random.default_rng(3)
    t, n = 5, 700
    per_lane = rs.integers(0, 500, size=(t, n, 3)).astype(np.int32)
    hist = rs.integers(0, 300_000, size=(t, 3)).astype(np.int32)
    return per_lane, hist


def _jax_omission_thin(drop_p):
    per_lane, hist = _omission_case()
    t, n, r, phase = 5, 700, 4, 1
    tid, nid = np.arange(2, 2 + t, dtype=np.int32), np.arange(n,
                                                               dtype=np.int32)
    return [np.asarray(J_OMISSION(jax.random.key(9), r, phase,
                                  np.ascontiguousarray(counts),
                                  np.float32(drop_p), tid, nid))
            for counts in (per_lane,
                           np.broadcast_to(hist[:, None, :], (t, n, 3)))]


@pytest.mark.parametrize("drop_p", [0.05, 0.3])
@prefetch(lambda drop_p: [(_jax_omission_thin, drop_p)])
def test_omission_thin_counts_matches_jax(drop_p):
    """Three binomial draws a lane on the salts phase + 8, + 24, + 40, over
    per-lane counts (a partition's group counts) and over a broadcast
    histogram (an expanded view on the port)."""
    t, n, r, phase = 5, 700, 4, 1
    per_lane, hist = _omission_case()
    wants = ref(_jax_omission_thin, drop_p)
    for tc, want in zip((torch.from_numpy(per_lane),
                         torch.from_numpy(hist)[:, None, :].expand(t, n, 3)),
                        wants):
        got = ttally.omission_thin_counts(
            9, r, phase, tc, drop_p, trng.ids(t, offset=2), trng.ids(n))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec,n", [("halves:3", 96), ("groups:3:3", 96),
                                    ("groups:5:2", 101), ("groups:7:4", 7)])
def test_partition_counts_matches_jax(spec, n):
    """The group histograms inside the epoch (r < heal_round) and the
    whole network's from the heal round on, over byzantine-flipped values
    and dead senders."""
    rs = np.random.default_rng(n)
    t = 4
    sent = rs.integers(0, 3, size=(t, n)).astype(np.int8)
    honest = rs.random((t, n)) < 0.8
    kw = dict(n_nodes=n, n_faulty=n // 4, trials=t, partition=spec)
    jc, tc = JCfg(**kw), TCfg(**kw)
    jp, tp = jpart.parse_partition(spec), tpart.parse_partition(spec)
    ids = np.arange(n, dtype=np.int32)
    for r in (1, tp.heal_round - 1, tp.heal_round, tp.heal_round + 3):
        if r < 1:
            continue
        want = np.asarray(J_PARTITION(jc, jp, sent, honest, ids, r))
        got = ttally.partition_counts(tc, tp, *_t(sent, honest),
                                      trng.ids(n), r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"r={r}")


_BAD_SPECS = ("halves", "halves:0", "groups:1:4", "groups:2", "thirds:3",
              "groups:x:4", "halves:1:2", "groups:2:3:4", "halves:x")


def test_partition_grammar_matches_jax():
    """tests/test_faults.py's partition grammar on the port: the parsed
    specs, the group sizes and ids, and every malformed spec's message,
    word for word."""
    for spec in ("halves:6", "groups:3:4", "groups:7:2"):
        js, ts = jpart.parse_partition(spec), tpart.parse_partition(spec)
        assert (ts.groups, ts.heal_round, ts.spec) == \
            (js.groups, js.heal_round, js.spec)
        for n in (10, 13, 96, 1_000_000):
            assert ts.group_sizes(n) == js.group_sizes(n)
    assert tpart.parse_partition(None) is None
    n, g = 13, 3
    ids = np.arange(n)
    np.testing.assert_array_equal(tpart.group_of(ids, n, g),
                                  jpart.group_of(ids, n, g))
    np.testing.assert_array_equal(
        tpart.group_of(torch.arange(n), n, g).numpy(),
        jpart.group_of(ids, n, g))
    sizes = tpart.parse_partition(f"groups:{g}:2").group_sizes(n)
    for i in range(n):
        assert tpart.group_size_of(i, n, tpart.parse_partition(
            f"groups:{g}:2")) == jpart.group_size_of(
                i, n, jpart.parse_partition(f"groups:{g}:2")) == \
            sizes[int(tpart.group_of(i, n, g))]
    for bad in _BAD_SPECS:
        with pytest.raises(ValueError) as want:
            jpart.parse_partition(bad)
        with pytest.raises(ValueError) as got:
            tpart.parse_partition(bad)
        assert str(got.value) == str(want.value), bad
    for spec, n in (("groups:9:3", 8), ("halves:3", 1)):
        with pytest.raises(ValueError) as want:
            jpart.parse_partition(spec).validate(n)
        with pytest.raises(ValueError) as got:
            tpart.parse_partition(spec).validate(n)
        assert str(got.value) == str(want.value), spec
    assert tfaults.parse_partition is tpart.parse_partition


@pytest.mark.parametrize("kw", [
    dict(partition="halves:0"), dict(partition="groups:9:3", n_nodes=8),
    dict(partition="halves:4", delivery="quorum"),
    dict(partition="halves:4", backend="express"),
    dict(partition="halves:4", fault_model="equivocate"),
    dict(partition="halves:4", committee_cap=4, committee_count=2,
         committee_size=8),
    dict(partition="halves:4"), dict(partition="groups:3:2",
                                     drop_prob=0.1),
], ids=str)
def test_partition_config_messages_match_jax(kw):
    """SimConfig(partition=...) accepts what the JAX package accepts and
    refuses the rest with its message, word for word."""
    kw = {"n_nodes": 16, "n_faulty": 2, **kw}
    try:
        JCfg(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TCfg(**kw)
        assert str(got.value) == str(e)
    else:
        assert TCfg(**kw).partition == kw["partition"]


# --- the exact shared tables ---------------------------------------------------

# (total, m) -> the most port draws differing from JAX's over the 1.6M
# uniforms below: twice the count measured (13, 43 and 3498, torch CPU
# against JAX 0.9.0)
TABLE_DRAW_BOUND = {(96, 72): 26, (256, 192): 86, (4096, 3072): 6996}


def _table_case(total, m):
    rs = np.random.default_rng(0)
    tot = np.full(4, total, np.int32)
    good = np.array([total // 2, total // 3, total // 4 + 1,
                     (3 * total) // 5], np.int32)
    u = rs.random((4, 400_000), dtype=np.float32)
    return tot, good, u


def _jax_exact_table(total, m):
    tot, good, u = _table_case(total, m)
    return np.asarray(J_TABLE(tot, good, m)), np.asarray(J_EXACT(u, tot, good,
                                                                 m))


@pytest.mark.parametrize("total,m", list(TABLE_DRAW_BOUND))
@prefetch(lambda total, m: [(_jax_exact_table, total, m)])
def test_exact_table_search_and_table_against_jax(total, m):
    """(1) The port's search handed JAX's CDF table gives JAX's draws
    exactly.  (2) The port's own table equals JAX's within the rounding of
    its three f32 log-gamma terms: relative 2 * eps * lgamma(total + 1) on
    every entry above 1e-8 (the log-pmf carries an absolute error of a few
    ulps of lgamma(total + 1)).  (3) Its draws differ from JAX's on at
    most twice the count measured."""
    tot, good, u = _table_case(total, m)
    jt, want = ref(_jax_exact_table, total, m)
    got = tsampling.shared_table_search(torch.from_numpy(jt),
                                        torch.from_numpy(u), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    tt = tsampling.hypergeom_cdf_table(*_t(tot, good), m)
    assert tt.dtype == torch.float32 and tt.shape == jt.shape
    rtol = 2 * np.finfo(np.float32).eps * float(
        torch.lgamma(torch.tensor(total + 1.0, dtype=torch.float64)))
    np.testing.assert_allclose(tt.numpy(), jt, rtol=rtol, atol=1e-8)

    draws = tsampling.hypergeom_exact_shared(*_t(u, tot, good), m).numpy()
    n_diff = int((draws != want).sum())
    rel = np.abs(tt.numpy() - jt)[jt > 1e-8] / jt[jt > 1e-8]
    print(f"exact table (total, m) = ({total}, {m}): {n_diff} of {u.size} "
          f"draws differ from JAX's (bound {TABLE_DRAW_BOUND[total, m]}); "
          f"table max relative difference {rel.max():.3g} (rtol {rtol:.3g})")
    assert n_diff <= TABLE_DRAW_BOUND[total, m]
