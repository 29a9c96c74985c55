"""The sweep engine of benor_tpu_torch against the JAX package, on the CPU:
``DynParams``, ``summarize_final`` on random final states, ``run_point``
in five regimes, the bucket keys of a mixed config list,
``run_points_batched`` (a dynamic bucket of three f values, a static
bucket, a point whose seed differs from the base's) with its sweep
journal resumed across the packages in both directions,
``run_consensus_traced`` with a ``DynParams`` other than its config's and
its refusals, ``record_trajectory``, ``coin_comparison_batched`` with its
odd-quorum refusal, and the build-ahead pipeline against the serial
dispatch.

N = 96, T = 8, in the CF regime (``EXACT_TABLE_MAX`` lowered to 4 in both
packages) unless a case says otherwise.  Every equality is exact; the
clocks (``seconds``, ``trials_per_sec``) are never compared.  Each JAX
comparison arms the recorder and the witness with the rest, so a mode
compiles once; the JAX side runs in the worker pool (torch_ref_pool) and
its caches are dropped when the module is done."""

import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu import sim as jsim
from benor_tpu import state as jstate
from benor_tpu import sweep as jsweep
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import sampling as jsampling
from benor_tpu.state import DynParams as JDyn
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu_torch import sim as tsim
from benor_tpu_torch import sweep as tsweep
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.state import DynParams as TDyn
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweepscope.journal import read_journal
from benor_tpu_torch.utils import metrics as tmetrics
from torch_ref_pool import prefetch, ref, start

N, T = 96, 8
CF_MAX = 4
MAX_ROUNDS = 12
OBS = dict(record=True, witness_trials=(0, 3), witness_nodes=4)
Q = dict(delivery="quorum", path="histogram")
SCIENCE = ("n_nodes", "n_faulty", "trials", "coin_mode", "scheduler",
           "rounds_executed", "decided_frac", "mean_k", "ones_frac",
           "disagree_frac")
ARRAYS = ("k_hist", "round_history", "witness")
FIELDS = ("x", "decided", "k", "killed")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


@pytest.fixture
def cf_regime(monkeypatch):
    """The CF regime at N = 96 in the port (the JAX sides lower their own
    bound)."""
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", CF_MAX)


class _cf_jax:
    """Lower the JAX package's EXACT_TABLE_MAX inside a worker call."""

    def __enter__(self):
        self.old = jsampling.EXACT_TABLE_MAX
        jsampling.EXACT_TABLE_MAX = CF_MAX

    def __exit__(self, *exc):
        jsampling.EXACT_TABLE_MAX = self.old


def _science(pt) -> dict:
    """A SweepPoint's fields but its clocks, as host values."""
    d = {k: getattr(pt, k) for k in SCIENCE}
    for k in ARRAYS:
        v = getattr(pt, k)
        d[k] = None if v is None else np.asarray(v).tolist()
    return d


def _faults(cls, kind):
    return cls.none(T, N) if kind == "none" else None


def _inputs(kind, seed):
    return (tsweep.balanced_inputs(T, N) if kind == "balanced"
            else tsweep.random_inputs(seed, T, N))


# --- DynParams and summarize_final ----------------------------------------

DYN_LISTS = {
    "f_axis": [dict(n_faulty=f) for f in (0, 17, 40, 95)],
    "committee_drop": [dict(n_faulty=3, committee_cap=4, committee_count=2,
                            committee_size=9),
                       dict(n_faulty=5, drop_prob=0.1),
                       dict(n_faulty=7, drop_prob=0.3)],
}


@pytest.mark.parametrize("name", list(DYN_LISTS))
def test_dynparams_matches_jax(name):
    """``DynParams.stack`` and ``from_config``: the JAX fields, dtypes
    (int32 four times, float32) and values, element for element."""
    kws = [dict(n_nodes=N, **kw) for kw in DYN_LISTS[name]]
    want = JDyn.stack([JCfg(**kw) for kw in kws])
    got = TDyn.stack([bt.SimConfig(**kw) for kw in kws])
    for f in ("n_faulty", "quorum", "committee_count", "committee_size",
              "drop_prob"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == (len(kws),), f
        np.testing.assert_array_equal(g, w, err_msg=f)
        one = getattr(TDyn.from_config(bt.SimConfig(**kws[1])), f)
        assert one.dim() == 0 and one.numpy() == w[1]


# (T, N, max_rounds, seed): k spans 0..max_rounds + 3, so the bins past
# max_rounds + 1 are dropped, as jnp.bincount drops them
SUMMARY_CASES = [(8, 96, 12, 1), (3, 50, 4, 2), (1, 7, 2, 3)]


def _summary_state(t, n, max_rounds, seed):
    rs = np.random.default_rng(seed)
    return dict(x=rs.integers(0, 3, size=(t, n)).astype(np.int8),
                decided=rs.random((t, n)) < 0.6,
                k=rs.integers(0, max_rounds + 4, size=(t, n)).astype(
                    np.int32),
                killed=rs.random((t, n)) < 0.2), rs.random((t, n)) < 0.3


def _jax_summary(t, n, max_rounds, seed):
    leaves, faulty = _summary_state(t, n, max_rounds, seed)
    out = jsweep.summarize_final(jstate.NetState(**leaves), faulty,
                                 max_rounds)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("case", SUMMARY_CASES, ids=str)
@prefetch(lambda case: [(_jax_summary, *case)])
def test_summarize_final_matches_jax(case):
    """The five summaries of random final states: the JAX dtypes (float32
    scalars, int32 counts) and values, exactly."""
    leaves, faulty = _summary_state(*case)
    got = tsweep.summarize_final(
        bt.NetState(**{k: torch.from_numpy(v) for k, v in leaves.items()}),
        torch.from_numpy(faulty), case[2])
    for g, w in zip(got, ref(_jax_summary, *case)):
        assert g.numpy().dtype == w.dtype and g.numpy().shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _jax_int32_sum(vals):
    return np.asarray(jax.numpy.sum(np.asarray(vals, np.int32)))


@prefetch(lambda: [(_jax_int32_sum, (2**30, 2**30, 2**30, 5))])
def test_int32_sum_wraps_as_jax():
    """Past 2^31 a summary's int32 sum wraps to the JAX package's value."""
    vals = (2**30, 2**30, 2**30, 5)
    got = tsweep._sum_i32(torch.tensor(vals, dtype=torch.int32))
    assert got.dtype == torch.int32
    assert int(got) == int(ref(_jax_int32_sum, vals)) < 0


# --- run_point ------------------------------------------------------------

# name -> (config overrides, faults, inputs); "default" runs run_point's
# default policy (random inputs, the first F nodes crashed)
POINT_MODES = {
    "cf_unfused": (dict(Q, n_faulty=40, seed=41), "none", "balanced"),
    "packed_fused": (dict(Q, n_faulty=40, use_pallas_hist=True,
                          use_pallas_round=True, seed=42), "none",
                     "balanced"),
    "adversarial_private": (dict(Q, scheduler="adversarial", n_faulty=40,
                                 seed=43), "none", "balanced"),
    "adversarial_common": (dict(Q, scheduler="adversarial",
                                coin_mode="common", n_faulty=40, seed=44),
                           "none", "balanced"),
    "committee": (dict(committee_cap=4, committee_count=4,
                       committee_size=12, n_faulty=1, seed=45), "default",
                  "default"),
}


def _point_kw(name):
    return dict(n_nodes=N, trials=T, max_rounds=MAX_ROUNDS,
                **POINT_MODES[name][0], **OBS)


def _jax_point(name):
    _, faults, inputs = POINT_MODES[name]
    cfg = JCfg(**_point_kw(name))
    with _cf_jax():
        if inputs == "default":
            pt = jsweep.run_point(cfg)
        else:
            pt = jsweep.run_point(cfg, initial_values=_inputs(inputs, 0),
                                  faults=_faults(JFaults, faults))
    return _science(pt)


@pytest.mark.parametrize("name", list(POINT_MODES))
@prefetch(lambda name: [(_jax_point, name)])
def test_run_point_matches_jax(name, cf_regime):
    """Every field of the SweepPoint but its clocks equals the JAX
    package's, the recorder's round history and the witness included."""
    _, faults, inputs = POINT_MODES[name]
    cfg = bt.SimConfig(**_point_kw(name))
    if inputs == "default":
        pt = tsweep.run_point(cfg, device="cpu")
    else:
        pt = tsweep.run_point(cfg, initial_values=_inputs(inputs, 0),
                              faults=_faults(TFaults, faults), device="cpu")
    assert pt.seconds > 0 and pt.trials_per_sec == T / pt.seconds
    assert _science(pt) == ref(_jax_point, name)


# --- the bucket keys ------------------------------------------------------

KEY_CONFIGS = [
    dict(Q, n_faulty=40), dict(Q, n_faulty=20), dict(Q, n_faulty=20, seed=3),
    dict(Q, n_faulty=40, use_pallas_hist=True, use_pallas_round=True),
    dict(Q, n_faulty=30, use_pallas_hist=True),
    dict(delivery="quorum", path="dense", n_faulty=10),
    dict(Q, scheduler="adversarial", n_faulty=10),
    dict(Q, scheduler="adversarial", n_faulty=20),
    dict(Q, scheduler="biased", adversary_strength=0.5, n_faulty=30),
    dict(n_faulty=4, fault_model="equivocate"),
    dict(n_faulty=30, drop_prob=0.1), dict(n_faulty=20, drop_prob=0.2),
    dict(n_faulty=20, partition="halves:3"),
    dict(n_faulty=2, topology="ring:2"), dict(n_faulty=4, topology="ring:4"),
    dict(n_faulty=1, committee_cap=4, committee_count=2, committee_size=8),
    dict(n_faulty=2, committee_cap=4, committee_count=4, committee_size=12),
    dict(Q, n_faulty=90),
]


def _grouping(mod, cfg_cls):
    """(kind, first-seen index of the key) of every config."""
    keys, out = [], []
    for kw in KEY_CONFIGS:
        key = mod.sweep_bucket_key(cfg_cls(n_nodes=N, **kw))
        if key not in keys:
            keys.append(key)
        out.append((key[0], keys.index(key)))
    return out


@pytest.mark.parametrize("table_max", [CF_MAX, 4096])
def test_bucket_keys_match_jax(table_max, monkeypatch):
    """The same static / dynamic verdict and the same grouping and bucket
    order as the JAX package's keys, in the CF regime and with the exact
    tables (which put the small quorums in static buckets)."""
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", table_max)
    monkeypatch.setattr(jsampling, "EXACT_TABLE_MAX", table_max)
    assert _grouping(tsweep, bt.SimConfig) == _grouping(jsweep, JCfg)


# --- run_points_batched and the journal across the packages --------------

BASE = dict(n_nodes=N, n_faulty=0, trials=T, max_rounds=MAX_ROUNDS, seed=5,
            **Q, **OBS)
# a dynamic bucket of three f values (a representative with F = 20 and
# points at 30 and 40), a static bucket (the dense top-k mask), and a
# point whose own seed differs from the base's (a bucket of its own that
# still runs from the base's seed)
BATCH = [dict(n_faulty=20), dict(n_faulty=30), dict(path="dense",
                                                    n_faulty=30),
         dict(n_faulty=40), dict(n_faulty=30, seed=11)]


def _batch_cfgs(cls):
    return cls(**BASE), [cls(**{**BASE, **kw}) for kw in BATCH]


def _curve(cb) -> dict:
    return dict(points=[_science(p) for p in cb.points],
                n_buckets=cb.n_buckets, sizes=cb.bucket_sizes,
                kinds=cb.bucket_kinds, idx=cb.bucket_point_indices,
                reused=cb.bucket_reused)


def _jax_batched():
    """The JAX run of BATCH with a journal -> (curve, journal text)."""
    base, cfgs = _batch_cfgs(JCfg)
    with tempfile.TemporaryDirectory() as d, _cf_jax():
        path = os.path.join(d, "journal.jsonl")
        cb = jsweep.run_points_batched(
            base, cfgs, initial_values=jsweep.balanced_inputs(T, N),
            faults_for=lambda c: JFaults.none(T, N), journal_path=path)
        with open(path) as fh:
            return _curve(cb), fh.read()


def _jax_resume(text):
    """JAX's resume of BATCH from a journal's text -> the curve.  Every
    bucket is restored, so nothing is compiled: it runs in this process."""
    base, cfgs = _batch_cfgs(JCfg)
    with tempfile.TemporaryDirectory() as d, _cf_jax():
        path = os.path.join(d, "journal.jsonl")
        with open(path, "w") as fh:
            fh.write(text)
        return _curve(jsweep.run_points_batched(
            base, cfgs, initial_values=jsweep.balanced_inputs(T, N),
            faults_for=lambda c: JFaults.none(T, N), journal_path=path,
            resume=True))


def _port_batched(tmp_path, name, resume=False, pipeline=False):
    base, cfgs = _batch_cfgs(bt.SimConfig)
    return tsweep.run_points_batched(
        base, cfgs, initial_values=tsweep.balanced_inputs(T, N),
        faults_for=lambda c: TFaults.none(T, N),
        journal_path=str(tmp_path / name), resume=resume,
        pipeline=pipeline, device="cpu")


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if '"sweep_bucket"' in line]


@prefetch(lambda: [(_jax_batched,)])
def test_run_points_batched_matches_jax(cf_regime, tmp_path):
    """The buckets (kinds, sizes, point indices, order) and every point's
    science fields equal the JAX package's; the journal records carry the
    same fingerprints, indices and payloads; no build or load on the
    CPU."""
    want, jtext = ref(_jax_batched)
    cb = _port_batched(tmp_path, "port.jsonl")
    assert _curve(cb) == want
    assert want["kinds"] == ["dyn", "static", "dyn"]
    assert cb.compile_count == 0 and cb.bucket_compile_counts == [0, 0, 0]
    mine = _records((tmp_path / "port.jsonl").read_text())
    theirs = _records(jtext)
    for a, b in zip(mine, theirs, strict=True):
        for k in ("bucket_index", "bucket_kind", "point_indices",
                  "fingerprint", "payload_sha256", "stamp_sha256", "points",
                  "journal_version", "mesh_shape", "pipelined"):
            assert a[k] == b[k], k


@prefetch(lambda: [(_jax_batched,)])
def test_jax_journal_resumes_on_port(cf_regime, tmp_path):
    """A journal the JAX package wrote resumes on the port with every
    bucket restored and the JAX run's points."""
    want, jtext = ref(_jax_batched)
    path = tmp_path / "jax.jsonl"
    path.write_text(jtext)
    base, cfgs = _batch_cfgs(bt.SimConfig)
    cb = tsweep.run_points_batched(
        base, cfgs, initial_values=tsweep.balanced_inputs(T, N),
        faults_for=lambda c: TFaults.none(T, N), journal_path=str(path),
        resume=True, device="cpu")
    assert cb.bucket_reused == [True] * 3
    assert _curve(cb) == {**want, "reused": [True] * 3}


def test_port_journal_resumes_in_jax(cf_regime, tmp_path):
    """A journal the port wrote resumes in the JAX package with every
    bucket restored and the port run's points."""
    cb = _port_batched(tmp_path, "port.jsonl")
    got = _jax_resume((tmp_path / "port.jsonl").read_text())
    assert got == {**_curve(cb), "reused": [True] * 3}


def test_pipeline_equals_serial(cf_regime, tmp_path):
    """The build-ahead scheduler gives the serial dispatch's points,
    per-bucket counts and journal records (but the pipelined flag and the
    stamp over it), and a resumed pipelined run restores every bucket."""
    serial = _port_batched(tmp_path, "serial.jsonl")
    piped = _port_batched(tmp_path, "piped.jsonl", pipeline=True)
    assert piped.pipelined and not serial.pipelined
    assert _curve(piped) == _curve(serial)
    assert piped.bucket_compile_counts == serial.bucket_compile_counts
    a = _records((tmp_path / "serial.jsonl").read_text())
    b = _records((tmp_path / "piped.jsonl").read_text())
    for ra, rb in zip(a, b, strict=True):
        assert rb["pipelined"] and not ra["pipelined"]
        for k in ("fingerprint", "point_indices", "points",
                  "payload_sha256", "compile_count", "bucket_kind"):
            assert ra[k] == rb[k], k
    again = _port_batched(tmp_path, "piped.jsonl", resume=True,
                          pipeline=True)
    assert again.bucket_reused == [True] * 3
    assert _curve(again) == {**_curve(serial), "reused": [True] * 3}
    assert [r["kind"] for r in read_journal(
        str(tmp_path / "piped.jsonl"))][-1] == "sweep_done"


# --- run_consensus_traced with DynParams ----------------------------------

# name -> (the representative's overrides, the point's overrides, faults):
# the loop runs under the representative's config and the point's
# DynParams, as a dynamic bucket runs a point
TRACED_MODES = {
    "targeted_equivocate": (dict(Q, scheduler="targeted",
                                 fault_model="equivocate", n_faulty=12),
                            dict(n_faulty=6), "first_f"),
    "biased_fractional": (dict(Q, scheduler="biased",
                               adversary_strength=0.5, n_faulty=40),
                          dict(n_faulty=30), "none"),
    "committee": (dict(committee_cap=4, committee_count=2,
                       committee_size=8, n_faulty=1),
                  dict(n_faulty=2, committee_count=4, committee_size=20),
                  "none"),
    "omission_dense": (dict(path="dense", drop_prob=0.1, n_faulty=30),
                       dict(n_faulty=20, drop_prob=0.25), "none"),
    "omission_histogram": (dict(path="histogram", drop_prob=0.1,
                                n_faulty=30),
                           dict(n_faulty=20, drop_prob=0.25), "none"),
    "biased_strict": (dict(Q, scheduler="biased", adversary_strength=1.5,
                           n_faulty=30), dict(n_faulty=20), "first_f"),
}


def _traced_kw(name):
    rep, point, faults = TRACED_MODES[name]
    kw = dict(n_nodes=N, trials=T, max_rounds=MAX_ROUNDS, seed=13,
              **rep, **OBS)
    return kw, {**kw, **point}, faults


def _jax_traced(name):
    kw, point, faults = _traced_kw(name)
    cfg = JCfg(**kw)
    fl = (JFaults.none(T, N) if faults == "none"
          else JFaults.from_faulty_list(cfg, np.arange(N) < cfg.n_faulty))
    with _cf_jax():
        run = jax.jit(jsim.run_consensus_traced, static_argnums=0)
        out = run(cfg, jstate.init_state(cfg, tsweep.balanced_inputs(T, N),
                                         fl), fl, jax.random.key(cfg.seed),
                  JDyn.from_config(JCfg(**point)))
    return (int(out[0]), {k: np.asarray(getattr(out[1], k)) for k in FIELDS},
            [np.asarray(o) for o in out[2:]])


@pytest.mark.parametrize("name", list(TRACED_MODES))
@prefetch(lambda name: [(_jax_traced, name)])
def test_run_consensus_traced_dyn_matches_jax(name, cf_regime):
    """The point's F, quorum, committee knobs and omission probability
    under the representative's config (the targeted camps, the biased
    delay race and strict priority, committees, omission on both paths):
    rounds, final state, recorder and witness equal the JAX package's."""
    kw, point, faults = _traced_kw(name)
    cfg = bt.SimConfig(**kw)
    fl = (TFaults.none(T, N) if faults == "none" else TFaults.first_f(cfg))
    out = tsim.run_consensus_traced(
        cfg, bt.init_state(cfg, tsweep.balanced_inputs(T, N), fl), fl,
        TDyn.from_config(bt.SimConfig(**point)))
    jr, jfields, jtails = ref(_jax_traced, name)
    assert out[0] == jr
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(out[1], k).numpy(),
                                      jfields[k], err_msg=k)
    assert len(out) == 2 + len(jtails)
    for g, w in zip(out[2:], jtails):
        np.testing.assert_array_equal(g.numpy(), w)


# the configs whose work is shaped by the quorum refuse a DynParams
REFUSALS = {
    "packed_round": dict(Q, use_pallas_hist=True, use_pallas_round=True),
    "fused_samplers": dict(Q, use_pallas_hist=True),
    "dense_mask": dict(delivery="quorum", path="dense"),
}


def _jax_refusal(name):
    cfg = JCfg(n_nodes=N, n_faulty=30, trials=T, **REFUSALS[name])
    fl = JFaults.none(T, N)
    with _cf_jax():
        try:
            jsim.run_consensus_traced(
                cfg, jstate.init_state(cfg, tsweep.balanced_inputs(T, N),
                                       fl), fl, jax.random.key(0),
                JDyn.from_config(cfg))
        except ValueError as e:
            return str(e)
    return None


@pytest.mark.parametrize("name", list(REFUSALS))
@prefetch(lambda name: [(_jax_refusal, name)])
def test_run_consensus_traced_refusals_match_jax(name, cf_regime):
    """The round kernels, the fused samplers and the dense quorum mask
    refuse a DynParams with the JAX package's ValueError."""
    cfg = bt.SimConfig(n_nodes=N, n_faulty=30, trials=T, **REFUSALS[name])
    fl = TFaults.none(T, N)
    with pytest.raises(ValueError) as e:
        tsim.run_consensus_traced(
            cfg, bt.init_state(cfg, tsweep.balanced_inputs(T, N), fl), fl,
            TDyn.from_config(cfg))
    assert str(e.value) == ref(_jax_refusal, name)


def test_run_consensus_traced_without_dyn_is_run_consensus(cf_regime):
    """dyn=None is run_consensus, on the unfused and the packed loop."""
    for over in (dict(Q, n_faulty=40),
                 dict(Q, n_faulty=40, use_pallas_hist=True,
                      use_pallas_round=True)):
        cfg = bt.SimConfig(n_nodes=N, trials=T, seed=3, **over)
        fl = TFaults.none(T, N)
        st = bt.init_state(cfg, tsweep.balanced_inputs(T, N), fl)
        a = tsim.run_consensus_traced(cfg, st, fl)
        b = bt.run_consensus(cfg, st, fl)
        assert a[0] == b[0]
        for k in FIELDS:
            assert torch.equal(getattr(a[1], k), getattr(b[1], k))


# --- record_trajectory ----------------------------------------------------

TRAJ = dict(n_nodes=N, n_faulty=40, trials=T, seed=17, **Q)
TRAJ_ROUNDS = 6


def _jax_trajectory():
    cfg = JCfg(**TRAJ)
    fl = JFaults.none(T, N)
    with _cf_jax():
        fin, traj = jsweep.record_trajectory(
            cfg, jstate.init_state(cfg, tsweep.balanced_inputs(T, N), fl),
            fl, jax.random.key(cfg.seed), TRAJ_ROUNDS)
    return ({k: np.asarray(getattr(fin, k)) for k in FIELDS},
            {k: np.asarray(v) for k, v in traj.items()})


@prefetch(lambda: [(_jax_trajectory,)])
def test_record_trajectory_matches_jax(cf_regime):
    """Exactly TRAJ_ROUNDS rounds: the final state and the five float32
    series equal the JAX package's, and the final state equals
    run_consensus's (the run ends within them)."""
    cfg = bt.SimConfig(**TRAJ)
    fl = TFaults.none(T, N)
    st = bt.init_state(cfg, tsweep.balanced_inputs(T, N), fl)
    fin, traj = tsweep.record_trajectory(cfg, st, fl, TRAJ_ROUNDS)
    jfin, jtraj = ref(_jax_trajectory)
    assert sorted(traj) == sorted(jtraj)
    for k, v in jtraj.items():
        assert traj[k].numpy().dtype == v.dtype and v.shape == (TRAJ_ROUNDS,)
        np.testing.assert_array_equal(traj[k].numpy(), v, err_msg=k)
    rounds, final = bt.run_consensus(cfg, st, fl)
    assert rounds < TRAJ_ROUNDS
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(fin, k).numpy(), jfin[k])
        assert torch.equal(getattr(fin, k), getattr(final, k))


def test_packed_trajectory_ends_at_run_consensus(cf_regime):
    """A packed-eligible config's trajectory runs the round kernels' plain
    versions a round at a time and ends at the packed run's state."""
    cfg = bt.SimConfig(**TRAJ, use_pallas_hist=True, use_pallas_round=True)
    fl = TFaults.none(T, N)
    st = bt.init_state(cfg, tsweep.balanced_inputs(T, N), fl)
    fin, traj = tsweep.record_trajectory(cfg, st, fl, TRAJ_ROUNDS)
    rounds, final = bt.run_consensus(cfg, st, fl)
    assert rounds < TRAJ_ROUNDS and float(traj["decided"][-1]) == 1.0
    for k in FIELDS:
        assert torch.equal(getattr(fin, k), getattr(final, k))


# --- coin_comparison_batched ----------------------------------------------

COIN = dict(n_nodes=N, n_faulty=0, trials=T, max_rounds=MAX_ROUNDS,
            seed=19, path="histogram")
COIN_FS = (20, 40, 60)


def _jax_coins():
    with _cf_jax():
        out = jsweep.coin_comparison_batched(JCfg(**COIN), COIN_FS,
                                             verbose=False)
    return {k: [_science(p) for p in v] for k, v in out.items()}


def _coin_refusal(mod, cls):
    try:
        mod.coin_comparison_batched(cls(**COIN), (20, 41), verbose=False)
    except ValueError as e:
        return str(e)
    return None


@prefetch(lambda: [(_jax_coins,)])
def test_coin_comparison_batched_matches_jax(cf_regime):
    """Both coins' curves equal the JAX package's point for point: at
    F = 40 >> sqrt(N) the private coin livelocks and the common coin
    decides; at F = 60 the bar m <= F stops both."""
    out = tsweep.coin_comparison_batched(bt.SimConfig(**COIN), COIN_FS,
                                         verbose=False, device="cpu")
    got = {k: [_science(p) for p in v] for k, v in out.items()}
    assert got == ref(_jax_coins)
    assert [p["decided_frac"] for p in got["private"][1:]] == [0.0, 0.0]
    assert [p["decided_frac"] for p in got["common"]] == [1.0, 1.0, 0.0]


def test_coin_comparison_odd_quorum_refusal_matches_jax():
    """An odd quorum on the f grid: the JAX package's ValueError."""
    want = _coin_refusal(jsweep, JCfg)
    assert want is not None
    assert _coin_refusal(tsweep, bt.SimConfig) == want


def test_engine_refusals():
    """A mesh, resume without a journal and points of another shape
    refuse, with the port's item number where one waits for it; a
    heartbeat, which raised before it was ported, runs and beats once a
    bucket with the points of the run without it."""
    base = bt.SimConfig(n_nodes=N, n_faulty=10, trials=T)
    with pytest.raises(NotImplementedError, match="item 15"):
        tsweep.run_points_batched(base, [base], mesh=object(), device="cpu")
    before = tmetrics.REGISTRY.counter("heartbeat.published").value
    beat = tsweep.run_points_batched(base.replace(heartbeat_rounds=2),
                                     [base], device="cpu")
    assert tmetrics.REGISTRY.counter("heartbeat.published").value == \
        before + beat.n_buckets
    plain = tsweep.run_points_batched(base, [base], device="cpu")
    assert [p.mean_k for p in beat.points] == [p.mean_k for p in plain.points]
    with pytest.raises(ValueError, match="journal_path"):
        tsweep.run_points_batched(base, [base], resume=True, device="cpu")
    with pytest.raises(ValueError, match="share base_cfg"):
        tsweep.run_points_batched(base, [base.replace(trials=2)],
                                  device="cpu")


# --- the per-point front doors, the presets and the points file ----------


def test_per_point_curves_equal_batched(cf_regime):
    """rounds_vs_f and coin_comparison (one run_point a point) give the
    batched engine's points: the same science through the other door."""
    base = bt.SimConfig(n_nodes=N, n_faulty=0, trials=T,
                        max_rounds=MAX_ROUNDS, seed=31, **Q)
    fs = (20, 40)
    a = tsweep.rounds_vs_f(base, fs, verbose=False, device="cpu")
    b = tsweep.rounds_vs_f_batched(base, fs, verbose=False, device="cpu")
    assert [_science(p) for p in a] == [_science(p) for p in b]
    one = tsweep.coin_comparison(base.replace(n_faulty=40), verbose=False,
                                 device="cpu")
    many = tsweep.coin_comparison_batched(base, (40,), verbose=False,
                                          device="cpu")
    assert {k: [_science(p) for p in v] for k, v in one.items()} == \
        {k: [_science(p) for p in v] for k, v in many.items()}
    with pytest.raises(ValueError, match="even quorum"):
        tsweep.coin_comparison(base.replace(n_faulty=41), device="cpu")


def test_baseline_configs_match_jax():
    """The five presets are the JAX package's, field for field."""
    import dataclasses
    want = {k: dataclasses.asdict(v)
            for k, v in jsweep.baseline_configs().items()}
    assert {k: dataclasses.asdict(v)
            for k, v in tsweep.baseline_configs().items()} == want


def test_save_points_matches_jax(tmp_path):
    """save_points writes the JAX package's file for the same points (the
    recorder and the witness included)."""
    cfg = dict(n_nodes=N, n_faulty=20, trials=T, record=True,
               witness_trials=(1,), witness_nodes=2)
    rs = np.random.default_rng(8)
    vals = [2, np.float32(0.75), np.float32(2.5), np.float32(0.5),
            rs.integers(0, 9, 14).astype(np.int32), np.float32(0.125),
            rs.integers(0, 9, (13, 7)).astype(np.int32),
            rs.integers(0, 9, (13, 1, 2, 9)).astype(np.int32)]
    for mod, cls, name in ((tsweep, bt.SimConfig, "port.json"),
                           (jsweep, JCfg, "jax.json")):
        mod.save_points(str(tmp_path / name),
                        [mod.point_from_raw(cls(**cfg), vals, 0.5)])
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
