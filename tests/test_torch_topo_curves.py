"""The structured planes' science curves of benor_tpu_torch against the JAX
package, on the CPU: ``results.topo_curves`` (the default degree ladder
through ``topo/curves.degree_curve`` and the committee-size sweep through
``committee_curve``) gives the JAX package's rows; the spec ladder, the
unanimity bar and the refusals are the JAX package's; a committee-count
curve is one dynamic bucket; a degree curve with a torus sorts its rows by
degree with each spec's metadata.

N = 80 (no square: the ladder is ring:2, ring:4, ring:8 and
random_regular:6:1), T = 4, 8 rounds.  Every equality is exact.  The JAX
side runs in the worker pool (torch_ref_pool) and its caches are dropped
when the module is done."""

import jax
import pytest

import benor_tpu_torch as bt
from benor_tpu import results as jresults
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.topo import curves as jcurves
from benor_tpu.topo import graphs as jgraphs
from benor_tpu_torch import results as tresults
from benor_tpu_torch.topo import curves as tcurves
from torch_ref_pool import prefetch, ref, start

N, T, SEED, ROUNDS = 80, 4, 3, 8


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _jax_topo_curves():
    out = jresults.topo_curves(N, T, seed=SEED, max_rounds=ROUNDS)
    return {k: out[k] for k in ("degree_curve", "committee_curve",
                                "committee_buckets")}


@prefetch(lambda: [(_jax_topo_curves,)])
def test_topo_curves_match_jax():
    """Every row of both curves equals the JAX package's (specs, degree,
    diameter, F, rounds, the rounded shares), and the committee curve is
    one bucket in both; the port builds and loads nothing on the CPU."""
    got = tresults.topo_curves(N, T, seed=SEED, max_rounds=ROUNDS,
                               device="cpu")
    want = ref(_jax_topo_curves)
    assert got["degree_curve"] == want["degree_curve"]
    assert got["committee_curve"] == want["committee_curve"]
    assert got["committee_buckets"] == want["committee_buckets"] == 1
    assert got["committee_compile_count"] == 0
    assert [r["spec"] for r in got["degree_curve"]] == [
        "ring:2", "ring:4", "random_regular:6:1", "ring:8"]


@pytest.mark.parametrize("n", [80, 81, 64, 4, 9])
def test_degree_ladder_and_bar_match_jax(n):
    """``default_degree_specs`` (a torus where N is a square of side >= 3)
    and ``unanimity_fault`` (F = d) are the JAX package's."""
    specs = tcurves.default_degree_specs(n)
    assert specs == jcurves.default_degree_specs(n)
    assert [tcurves.unanimity_fault(s) for s in specs] == [
        jcurves.unanimity_fault(s) for s in specs]


def _message(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def test_curve_refusals_match_jax():
    """'complete' on the degree axis and a committee curve with both or
    neither axis refuse with the JAX package's messages."""
    tb = bt.SimConfig(n_nodes=N, n_faulty=0, trials=T)
    jb = JCfg(n_nodes=N, n_faulty=0, trials=T)
    cases = [
        (tcurves.unanimity_fault, jcurves.unanimity_fault,
         ("complete",), {}, {}),
        (tcurves.degree_curve, jcurves.degree_curve,
         (None, ["ring:2", "complete"]), {}, dict(device="cpu")),
        (tcurves.committee_curve, jcurves.committee_curve, (None,),
         dict(sizes=[4], counts=[2]), dict(device="cpu")),
        (tcurves.committee_curve, jcurves.committee_curve, (None,), {},
         dict(device="cpu")),
    ]
    for tfn, jfn, args, kw, dev in cases:
        targs = tuple(tb if a is None else a for a in args)
        jargs = tuple(jb if a is None else a for a in args)
        want = _message(jfn, *jargs, **kw)
        assert want is not None
        assert _message(tfn, *targs, **kw, **dev) == want


def test_committee_count_curve_is_one_bucket():
    """A committee-count curve shares the cap, so its points make one
    dynamic bucket; every row carries its count and the cap."""
    rows, cb = tcurves.committee_curve(
        bt.SimConfig(n_nodes=N, n_faulty=1, trials=T, max_rounds=ROUNDS,
                     seed=SEED), counts=[2, 3, 4], committee_size=10,
        device="cpu")
    assert cb.n_buckets == 1 and cb.bucket_kinds == ["dyn"]
    assert [(r["committee_count"], r["committee_cap"]) for r in rows] == [
        (2, 4), (3, 4), (4, 4)]


def test_degree_curve_with_torus_sorts_by_degree():
    """A torus and a ring: one bucket each, the rows sorted by degree,
    each with the spec's metadata as the JAX package computes it."""
    specs = ["torus2d:8x10", "ring:2"]
    rows = tcurves.degree_curve(
        bt.SimConfig(n_nodes=N, n_faulty=0, trials=T, max_rounds=ROUNDS,
                     seed=SEED), specs, n_faulty_for=lambda s: 1,
        device="cpu")
    assert [r["spec"] for r in rows] == ["ring:2", "torus2d:8x10"]
    for row in rows:
        meta = jgraphs.parse_topology(row["spec"]).metadata(N)
        assert {k: row[k] for k in meta} == meta
        assert row["n_faulty"] == 1
