"""Resume on benor_tpu_torch against the JAX package, on the CPU: the sweep
journal's bucket fingerprints equal the JAX package's for the same
configs, initial values and fault masks (every field type of the config
and every fault plane); a tampered record and a torn last line rerun their
bucket, with the uninterrupted run's points; and a checkpoint round-trips
between the packages in both directions, its resume equal to the
uninterrupted run.

N = 96, T = 8, in the CF regime (``EXACT_TABLE_MAX`` lowered to 4 in both
packages) where a run is made.  Every equality is exact.  The JAX side runs
in the worker pool (torch_ref_pool) and its caches are dropped when the
module is done."""

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
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.faults.recovery import crash_recover_faults as j_recover
from benor_tpu.ops import sampling as jsampling
from benor_tpu.state import FaultSpec as JFaults
from benor_tpu.sweepscope import journal as jjournal
from benor_tpu.utils import checkpoint as jckpt
from benor_tpu_torch import sweep as tsweep
from benor_tpu_torch.faults.recovery import crash_recover_faults as t_recover
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.sim import start_state as t_start
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweepscope import journal as tjournal
from benor_tpu_torch.utils import checkpoint as tckpt
from torch_ref_pool import prefetch, ref, start

N, T = 96, 8
CF_MAX = 4
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
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", CF_MAX)


# --- the fingerprints -----------------------------------------------------

# name -> (the bucket's point configs, faults); every field type of the
# config appears: ints, floats, strings, None, bools, tuples (the witness
# trials, the mesh shape) and the three spec grammars
FP_BUCKETS = {
    "f_axis": ([dict(n_faulty=f) for f in (10, 20, 30)], "first_f"),
    "observed": ([dict(n_faulty=20, record=True, witness_trials=(0, 3),
                       witness_nodes=4, coin_mode="weak_common",
                       coin_eps=0.25, drop_prob=0.05)], "none"),
    "recover": ([dict(n_faulty=12, fault_model="crash_recover",
                      recovery="at:2:3:amnesia")], "recover"),
    "structured": ([dict(n_faulty=4, topology="torus2d:8x12",
                         partition="halves:3"),
                    dict(n_faulty=1, committee_cap=4, committee_count=2,
                         committee_size=9, mesh_shape=(1, 2))], "none"),
}


def _fp_faults(cls, recover, cfg, kind):
    if kind == "none":
        return cls.none(T, N)
    if kind == "recover":
        return recover(cfg)
    return cls.from_faulty_list(cfg, np.arange(N) < cfg.n_faulty)


def _fp_inputs():
    return tsweep.random_inputs(3, T, N)


def _jax_fingerprint(name):
    kws, kind = FP_BUCKETS[name]
    cfgs = [JCfg(n_nodes=N, trials=T, **kw) for kw in kws]
    faults = [_fp_faults(JFaults, j_recover, c, kind)
              for c in cfgs]
    return jjournal.bucket_fingerprint(cfgs, _fp_inputs(), faults)


@pytest.mark.parametrize("name", list(FP_BUCKETS))
@prefetch(lambda name: [(_jax_fingerprint, name)])
def test_bucket_fingerprint_matches_jax(name):
    """The same configs, inputs and fault masks hash to the JAX package's
    fingerprint, byte for byte (the masks built by each package's own
    fault policy)."""
    kws, kind = FP_BUCKETS[name]
    cfgs = [bt.SimConfig(n_nodes=N, trials=T, **kw) for kw in kws]
    faults = [_fp_faults(TFaults, t_recover, c, kind)
              for c in cfgs]
    assert tjournal.bucket_fingerprint(cfgs, _fp_inputs(), faults) == \
        ref(_jax_fingerprint, name)


DEFAULT_FAULTS = {
    "crash": dict(n_faulty=30),
    "crash_recover": dict(n_faulty=12, fault_model="crash_recover",
                          recovery="at:2:3:amnesia"),
}


def _jax_default_faults(name):
    from benor_tpu.sweep import default_crash_faults
    fl = default_crash_faults(JCfg(n_nodes=N, trials=T,
                                   **DEFAULT_FAULTS[name]))
    return [None if a is None else np.asarray(a)
            for a in (fl.faulty, fl.crash_round, fl.recover_round)]


@pytest.mark.parametrize("name", list(DEFAULT_FAULTS))
@prefetch(lambda name: [(_jax_default_faults, name)])
def test_default_crash_faults_match_jax(name):
    """The default fault policy gives the JAX package's masks: the first F
    lanes crashed, or their down-intervals from the recovery spec; without
    a spec crash_recover refuses with the JAX package's message."""
    fl = tsweep.default_crash_faults(bt.SimConfig(
        n_nodes=N, trials=T, **DEFAULT_FAULTS[name]))
    got = [None if a is None else a.numpy()
           for a in (fl.faulty, fl.crash_round, fl.recover_round)]
    for g, w in zip(got, ref(_jax_default_faults, name), strict=True):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if name == "crash_recover":
        from benor_tpu.sweep import default_crash_faults as jdefault
        bare = dict(n_nodes=N, trials=T, n_faulty=12,
                    fault_model="crash_recover")
        with pytest.raises(ValueError) as want:
            jdefault(JCfg(**bare))
        with pytest.raises(ValueError) as got_e:
            tsweep.default_crash_faults(bt.SimConfig(**bare))
        assert str(got_e.value) == str(want.value)


def test_payload_serialization_round_trips():
    """serialize -> JSON -> deserialize -> point_from_raw gives the point
    back, float32 summaries, histograms and buffers exactly."""
    cfg = bt.SimConfig(n_nodes=N, n_faulty=20, trials=T, record=True,
                       witness_trials=(1,), witness_nodes=2)
    rs = np.random.default_rng(4)
    vals = [3, np.float32(0.1), np.float32(2.3), np.float32(1 / 3),
            rs.integers(0, 9, 14).astype(np.int32), np.float32(0.125),
            rs.integers(0, 9, (13, 7)).astype(np.int32),
            rs.integers(0, 9, (13, 1, 2, 9)).astype(np.int32)]
    payload = json.loads(json.dumps(tjournal.serialize_point(cfg, vals)))
    assert payload == jjournal.serialize_point(cfg, vals)
    a = tsweep.point_from_raw(cfg, vals, 1.0)
    b = tsweep.point_from_raw(cfg, tjournal.deserialize_point(cfg, payload),
                              1.0)
    for k in ("decided_frac", "mean_k", "ones_frac", "disagree_frac",
              "rounds_executed"):
        assert getattr(a, k) == getattr(b, k)
    for k in ("k_hist", "round_history", "witness"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# --- tampered and torn journals rerun -------------------------------------

BASE = dict(n_nodes=N, n_faulty=0, trials=T, max_rounds=12, seed=23,
            delivery="quorum", path="histogram")
# three buckets: a dynamic bucket of two f values, a static one (the dense
# top-k mask), a dynamic bucket of one (its own seed)
POINTS = [dict(n_faulty=20), dict(n_faulty=40), dict(n_faulty=30,
                                                     path="dense"),
          dict(n_faulty=30, seed=4)]


def _run(path, resume=False):
    base = bt.SimConfig(**BASE)
    return tsweep.run_points_batched(
        base, [bt.SimConfig(**{**BASE, **kw}) for kw in POINTS],
        initial_values=tsweep.balanced_inputs(T, N),
        faults_for=lambda c: TFaults.none(T, N), journal_path=str(path),
        resume=resume, device="cpu")


def _edit_payload(lines):
    rec = json.loads(lines[0])
    rec["points"][0]["mean_k"] += 1.0
    lines[0] = json.dumps(rec)


def _edit_mesh(lines):
    rec = json.loads(lines[1])
    rec["mesh_shape"] = [2, 1]
    lines[1] = json.dumps(rec)


def _edit_indices(lines):
    rec = json.loads(lines[0])
    rec["point_indices"] = rec["point_indices"][::-1]
    lines[0] = json.dumps(rec)


def _torn_tail(lines):
    # cut after the second record, as a kill would, and leave half a line
    del lines[2:]
    lines.append(lines[1][: len(lines[1]) // 2])


# name -> (edit of the journal's lines, the buckets that must rerun)
TAMPERS = {
    "payload": (_edit_payload, [0]),
    "mesh_provenance": (_edit_mesh, [1]),
    "indices": (_edit_indices, [0]),
    "torn_tail": (_torn_tail, [2]),
}


@pytest.mark.parametrize("name", list(TAMPERS))
def test_tampered_journal_reruns(name, cf_regime, tmp_path):
    """Each tamper reruns exactly its bucket; every other bucket is
    restored; the points equal the uninterrupted run's."""
    path = tmp_path / "journal.jsonl"
    full = _run(path)
    assert full.n_buckets == 3
    edit, rerun = TAMPERS[name]
    lines = path.read_text().splitlines()
    edit(lines)
    path.write_text("\n".join(lines) + "\n")
    again = _run(path, resume=True)
    assert again.bucket_reused == [i not in rerun for i in range(3)]
    for a, b in zip(full.points, again.points, strict=True):
        for k in ("rounds_executed", "decided_frac", "mean_k", "ones_frac",
                  "disagree_frac", "n_faulty"):
            assert getattr(a, k) == getattr(b, k)
        np.testing.assert_array_equal(a.k_hist, b.k_hist)


# --- checkpoints across the packages -------------------------------------

CKPT = dict(n_nodes=N, n_faulty=40, trials=T, max_rounds=16, seed=29,
            delivery="quorum", path="histogram",
            fault_model="crash_recover", recovery="at:1:3")
CUT = 3          # the checkpoint holds the state before round CUT


def _inputs():
    return tsweep.balanced_inputs(T, N)


def _jax_from_port_checkpoint(data):
    """JAX's resume of a port checkpoint's bytes -> (rounds, final)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        with open(path, "wb") as fh:
            fh.write(data)
        old = jsampling.EXACT_TABLE_MAX
        jsampling.EXACT_TABLE_MAX = CF_MAX
        try:
            rounds, final, _ = jckpt.resume_from(path)
        finally:
            jsampling.EXACT_TABLE_MAX = old
    return int(rounds), {k: np.asarray(getattr(final, k)) for k in FIELDS}


def _jax_checkpoint():
    """A JAX checkpoint at round CUT -> (its bytes, the saved state)."""
    cfg = JCfg(**CKPT)
    fl = j_recover(cfg)
    old = jsampling.EXACT_TABLE_MAX
    jsampling.EXACT_TABLE_MAX = CF_MAX
    try:
        st = jsim.start_state(cfg, jstate.init_state(cfg, _inputs(), fl))
        nxt, st = jsim.run_consensus_slice(cfg, st, fl,
                                           jax.random.key(cfg.seed), 1, CUT)
    finally:
        jsampling.EXACT_TABLE_MAX = old
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        jckpt.save_checkpoint(path, cfg, st, fl, int(nxt))
        with open(path, "rb") as fh:
            return fh.read(), {k: np.asarray(getattr(st, k))
                               for k in FIELDS}


def _uninterrupted():
    cfg = bt.SimConfig(**CKPT)
    fl = t_recover(cfg)
    return bt.run_consensus(cfg, bt.init_state(cfg, _inputs(), fl), fl)


def _port_checkpoint(path):
    cfg = bt.SimConfig(**CKPT)
    fl = t_recover(cfg)
    st = t_start(cfg, bt.init_state(cfg, _inputs(), fl))
    nxt, st = bt.run_consensus_slice(cfg, st, fl, 1, CUT)
    assert nxt == CUT
    tckpt.save_checkpoint(str(path), cfg, st, fl, nxt)
    return st


@prefetch(lambda: [(_jax_checkpoint,)])
def test_jax_checkpoint_resumes_on_port(cf_regime, tmp_path):
    """A JAX checkpoint (crash_recover: its recover_round key included)
    holds the port's state at round CUT, loads on the port, and resumes to
    the uninterrupted run's rounds and final state."""
    data, jstate_cut = ref(_jax_checkpoint)
    path = tmp_path / "jax.npz"
    path.write_bytes(data)
    mine = _port_checkpoint(tmp_path / "port.npz")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(mine, k).numpy(),
                                      jstate_cut[k], err_msg=k)
    cfg, st, fl, nxt, kd = tckpt.load_checkpoint(str(path))
    assert cfg == bt.SimConfig(**CKPT) and nxt == CUT
    assert fl.recover_round is not None
    np.testing.assert_array_equal(kd, tckpt.key_data(CKPT["seed"]))
    rounds, final, _ = tckpt.resume_from(str(path), device="cpu")
    want_r, want = _uninterrupted()
    assert rounds == want_r > CUT
    for k in FIELDS:
        assert torch.equal(getattr(final, k), getattr(want, k)), k


_PORT_CKPT = []


def _port_checkpoint_bytes():
    """The bytes of the port's checkpoint (made once, in the CF regime, so
    the JAX resume of these very bytes is computed ahead in the pool)."""
    if not _PORT_CKPT:
        old = tsampling.EXACT_TABLE_MAX
        tsampling.EXACT_TABLE_MAX = CF_MAX
        try:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "port.npz")
                _port_checkpoint(path)
                with open(path, "rb") as fh:
                    _PORT_CKPT.append(fh.read())
        finally:
            tsampling.EXACT_TABLE_MAX = old
    return _PORT_CKPT[0]


@prefetch(lambda: [(_jax_from_port_checkpoint, _port_checkpoint_bytes())])
def test_port_checkpoint_resumes_in_jax(cf_regime, tmp_path):
    """A port checkpoint loads in the JAX package (same keys, version and
    config text) and JAX's resume_from gives the port's uninterrupted
    run."""
    path = tmp_path / "port.npz"
    path.write_bytes(_port_checkpoint_bytes())
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["key_data", "x", "decided", "k", "killed", "faulty",
             "crash_round", "recover_round", "next_round", "version",
             "config_json"])
        assert int(z["version"]) == 2
    jr, jfinal = ref(_jax_from_port_checkpoint, _port_checkpoint_bytes())
    want_r, want = _uninterrupted()
    assert jr == want_r
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(want, k).numpy(), jfinal[k],
                                      err_msg=k)


def test_checkpoint_refusals(cf_regime, tmp_path):
    """A key the config's seed does not give, another format version and a
    real mesh refuse; the recorded mesh shape reads back; mesh='auto'
    resumes on one device."""
    path = tmp_path / "c.npz"
    cfg = bt.SimConfig(n_nodes=N, n_faulty=10, trials=T, seed=5)
    fl = TFaults.none(T, N)
    st = bt.init_state(cfg, _inputs(), fl)
    with pytest.raises(ValueError, match="cfg.seed"):
        tckpt.save_checkpoint(str(path), cfg, st, fl, 1, base_key=[0, 6])
    tckpt.save_checkpoint(str(path), cfg, st, fl, 1, mesh_shape=(2, 1))
    assert tckpt.saved_mesh_shape(str(path)) == (2, 1)
    with pytest.raises(NotImplementedError, match="item 15"):
        tckpt.resume_from(str(path), mesh=object(), device="cpu")
    rounds, _, _ = tckpt.resume_from(str(path), mesh="auto", device="cpu")
    assert rounds >= 1
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    for edit, match in ((dict(key_data=np.asarray([0, 6], np.uint32)),
                         "not the key"),
                        (dict(version=np.int32(3)), "version 3")):
        with open(path, "wb") as fh:
            np.savez(fh, **{**payload, **edit})
        with pytest.raises(ValueError, match=match):
            tckpt.load_checkpoint(str(path))


def test_sweep_modules_import_without_jax(tmp_path):
    """With ``jax`` made unimportable, the engine, the journal, the
    scheduler, the checkpoints and the curves import and run a journaled,
    pipelined, resumed sweep, a checkpoint and the topo curves on the CPU;
    no ``benor_tpu`` module is ever loaded."""
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        from benor_tpu_torch import SimConfig, init_state
        from benor_tpu_torch.results import topo_curves
        from benor_tpu_torch.sweep import run_curve_batched, default_crash_faults
        from benor_tpu_torch.utils.checkpoint import resume_from, save_checkpoint
        base = SimConfig(n_nodes=64, n_faulty=0, trials=2, max_rounds=8,
                         delivery="quorum", path="histogram")
        j = {str(tmp_path / "j.jsonl")!r}
        a = run_curve_batched(base, [8, 16], journal_path=j, pipeline=True,
                              device="cpu")
        b = run_curve_batched(base, [8, 16], journal_path=j, resume=True,
                              device="cpu")
        cfg = base.replace(n_faulty=8)
        fl = default_crash_faults(cfg)
        save_checkpoint({str(tmp_path / "c.npz")!r}, cfg,
                        init_state(cfg, [0, 1] * 32, fl), fl, 1)
        r, _, _ = resume_from({str(tmp_path / "c.npz")!r}, device="cpu")
        rows = topo_curves(36, 2, max_rounds=4, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m == "benor_tpu" or m.startswith("benor_tpu."))
        print("OK", b.bucket_reused, r, len(rows["degree_curve"]), bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__)))},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("OK [True, True]"), out.stdout
    assert out.stdout.strip().endswith("5 []"), out.stdout
