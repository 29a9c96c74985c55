"""The port's request plane (benor_tpu_torch/serve/) against the JAX
package's, on the CPU.

A served job equals a direct run: for each job kind (simulate, a sweep of
three f values, trajectory, audit), on a dynamic bucket (the
``DEFAULT_JOB`` shape, ``delivery='all'``) and a static one (quorum
delivery on the histogram path, its quorum an exact table), the port's
served ``result`` equals ``result_dict`` of the port's ``run_point`` of
the job's config and the JAX package's ``result_dict(run_point(cfg),
spec)``, leaving out only ``seconds``, ``trials_per_sec``, ``job`` and
``batch_jobs``; a trajectory job's ``round`` rows equal the JAX recorder's
rows, an audit job's ``witness`` rows and verdict the JAX auditor's.  The
JAX runs arm the recorder and the witness at once (observability changes
no result), so one JAX config serves the three kinds of an f value; they
run in the worker pool (torch_ref_pool).

The job documents (``JobSpec.from_dict`` rejections, ``to_dict`` /
``from_config`` round trips), ``serve_bucket_key`` with the seed erased,
the capacity rungs of ``_capacity_for`` and the stage model equal the JAX
package's (pure Python on both sides).  ``compare_serve`` gives the JAX
findings on the committed SERVE_BASELINE.json and its injected
regressions.  The batcher coalesces, cancels, schedules round robin,
stamps every transition, reports pad slots and survives a failed batch;
the HTTP routes run over real sockets on port 0; a small ``load`` writes
a manifest the JAX schema checker accepts."""

import copy
import dataclasses
import importlib.util
import json
import os
import socket
import time

import jax
import pytest

from benor_tpu.config import SimConfig as JCfg
from benor_tpu.serve import batcher as jbatcher
from benor_tpu.serve import gate as jgate
from benor_tpu.serve import jobs as jjobs
from benor_tpu_torch.serve import (Batcher, DEFAULT_JOB, JobError, JobSpec,
                                   ServeApp, compare_serve, run_load,
                                   serve_bucket_key)
from benor_tpu_torch.serve import gate as tgate
from benor_tpu_torch.serve import jobs as tjobs
from benor_tpu_torch.sweep import run_point
from benor_tpu_torch.utils.metrics import REGISTRY, SPANS
from torch_ref_pool import prefetch, ref, start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the dynamic bucket: the load generator's job
DYN = dict(DEFAULT_JOB)
#: the static bucket: quorum 56 <= EXACT_TABLE_MAX, an exact shared table
STATIC = {"kind": "simulate", "n_nodes": 64, "n_faulty": 8, "trials": 4,
          "max_rounds": 16, "delivery": "quorum", "path": "histogram"}
BUCKETS = {"dyn": (DYN, (1, 4, 7)), "static": (STATIC, (6, 8, 10))}
KINDS = ("simulate", "sweep", "trajectory", "audit")
#: what differs by design between a served result and a direct run's
CLOCKS = ("seconds", "trials_per_sec", "job", "batch_jobs")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


def _strip(res):
    return {k: v for k, v in res.items() if k not in CLOCKS}


# --- the JAX side (worker pool) ----------------------------------------------


def _jax_point(doc, f, armed):
    """JAX result_dict(run_point(cfg), spec) of the job ``doc`` at F = f,
    for each kind whose result it is; ``armed`` arms the recorder and the
    witness and adds the round rows, the witness rows and the verdict."""
    from benor_tpu.audit import WitnessBundle, audit_witness, witness_rows
    from benor_tpu.state import witness_node_ids
    from benor_tpu.sweep import default_crash_faults
    from benor_tpu.sweep import run_point as jrun_point
    from benor_tpu.utils.metrics import round_history_rows
    doc = {**doc, "n_faulty": f}
    kind = "audit" if armed else "simulate"
    cfg = jjobs.JobSpec.from_dict({**doc, "kind": kind}).to_config()
    if armed:
        cfg = cfg.replace(record=True)
    pt = jrun_point(cfg)
    kinds = ("simulate", "trajectory", "audit") if armed else ("simulate",)
    out = {"results": {k: _strip(jjobs.result_dict(
        pt, jjobs.JobSpec.from_dict({**doc, "kind": k}))) for k in kinds}}
    if armed:
        out["rounds"] = round_history_rows(pt.round_history)
        out["witness"] = witness_rows(pt.witness, cfg.witness_trials,
                                      witness_node_ids(cfg))
        report = audit_witness(WitnessBundle.from_run(
            cfg, pt.witness, faults=default_crash_faults(cfg)))
        out["audit"] = {"ok": report.ok,
                        "violations": len(report.violations),
                        "summary": report.summary()}
    return json.loads(json.dumps(out))


def _armed_f(bucket):
    return BUCKETS[bucket][1][1]


def _jax_calls(bucket, kind):
    doc, fs = BUCKETS[bucket]
    if kind == "sweep":
        return [(_jax_point, doc, f, f == _armed_f(bucket)) for f in fs]
    return [(_jax_point, doc, _armed_f(bucket), True)]


# --- the port's served jobs --------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Every kind on both buckets, submitted to one batcher and drained:
    {(bucket, kind): [jobs]}."""
    b = Batcher(start=False, device="cpu")
    out = {}
    for bucket, (doc, fs) in BUCKETS.items():
        f = _armed_f(bucket)
        for kind in KINDS:
            sub = {**doc, "kind": kind, "n_faulty": f}
            if kind == "sweep":
                sub["f_values"] = list(fs)
            out[bucket, kind] = b.submit_dict(sub)
    while b.step():
        pass
    return out, b


@prefetch(lambda bucket, kind: _jax_calls(bucket, kind))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_served_job_equals_run_point_and_jax(served, bucket, kind):
    jobs = served[0][bucket, kind]
    doc, fs = BUCKETS[bucket]
    want_fs = fs if kind == "sweep" else (_armed_f(bucket),)
    assert [j.cfg.n_faulty for j in jobs] == list(want_fs)
    for job, (_, _, f, armed) in zip(jobs, _jax_calls(bucket, kind)):
        assert job.state == "done" and job.bucket[0] == bucket
        got = _strip(job.result)
        blob = got.pop("audit", None)
        direct = _strip(tjobs.result_dict(run_point(job.cfg, device="cpu"),
                                          job.spec))
        jax_doc = ref(_jax_point, doc, f, armed)
        assert got == direct == jax_doc["results"][job.spec.kind]
        assert got["kind"] == ("simulate" if kind == "sweep" else kind)
        events = {t for t, _ in job.events}
        if kind == "trajectory":
            rows = [p for t, p in job.events if t == "round"]
            assert rows == jax_doc["rounds"] and rows[0]["round"] == 0
        else:
            assert "round" not in events
        if kind == "audit":
            assert [p for t, p in job.events if t == "witness"] == \
                jax_doc["witness"]
            assert blob == jax_doc["audit"] == \
                [p for t, p in job.events if t == "audit"][0]
            assert blob["ok"]
        else:
            assert blob is None and "witness" not in events


def test_served_batches_coalesce_by_bucket(served):
    """The dynamic simulate and the sweep's three points shared one launch
    (capacity 4); a static bucket keys on F, so the static simulate shares
    a batch with the sweep's point at its F only, and each static job is a
    launch of its own; every batcher stamp is taken in order and the
    stages telescope."""
    jobs, b = served
    dyn = jobs["dyn", "simulate"] + jobs["dyn", "sweep"]
    assert {j.bucket for j in dyn} == {dyn[0].bucket}
    assert {j.launch_jobs for j in dyn} == {4}
    assert [j.launch_jobs for j in jobs["static", "sweep"]] == [1, 2, 1]
    assert b.launches == 1 + 1 + 1 + 6       # dyn, trajectory, audit, static
    assert b.jobs_completed == b.jobs_submitted == 12
    assert b.executor_compiles == 0 and b.stats()["executors"] == 8
    want = [s for s in tjobs.STAGE_STAMPS if s != "first_sse"]
    for job in dyn:
        assert [s for s in tjobs.STAGE_STAMPS if s in job.stamps] == want
        times = [job.stamps[s] for s in want]
        assert times == sorted(times)
        assert sum(tjobs.stage_durations(job.stamps).values()) == \
            pytest.approx(job.stamps["done"] - job.stamps["accepted"])


# --- job documents -----------------------------------------------------------


REJECTED = [
    [1, 2], {"kind": "nope"}, {"n_nodes": "ten"}, {"n_nodes": True},
    {"trials": 0}, {"n_nodes": 1 << 20}, {"seed": -1}, {"bogus_knob": 1},
    {"kind": "sweep"}, {"kind": "sweep", "f_values": [1, "x"]},
    {"kind": "sweep", "f_values": list(range(65))},
    {"kind": "simulate", "f_values": [1]}, {"n_nodes": 8, "n_faulty": 9},
    {"delivery": "all", "scheduler": "adversarial"},
    {"committee_cap": 1 << 11}, {"topology": 3}, {"topology": "ring:x"},
    {"recovery": 1.5}, {"max_rounds": 1 << 11}, {"coin_eps": "x"},
]


@pytest.mark.parametrize("doc", REJECTED, ids=lambda d: json.dumps(d)[:40])
def test_jobspec_rejections_match_jax(doc):
    """The structured 400 bodies, word for word."""
    with pytest.raises(JobError) as ti:
        JobSpec.from_dict(doc)
    with pytest.raises(jjobs.JobError) as ji:
        jjobs.JobSpec.from_dict(doc)
    assert ti.value.body == ji.value.body and str(ti.value) == str(ji.value)
    assert ti.value.body["error"] == "invalid job"


ACCEPTED = [
    {}, DYN, STATIC, {**DYN, "kind": "sweep", "f_values": [1, 2]},
    {**DYN, "kind": "trajectory", "coin_mode": "weak_common",
     "coin_eps": 1},
    {**STATIC, "kind": "audit", "seed": 9},
    {"n_nodes": 64, "n_faulty": 4, "topology": "torus2d:8x8"},
    {"n_nodes": 64, "n_faulty": 4, "committee_cap": 8,
     "committee_count": 4, "committee_size": 16},
    {"n_nodes": 64, "n_faulty": 4, "drop_prob": 0.1},
    {"n_nodes": 64, "n_faulty": 4, "fault_model": "crash_recover",
     "recovery": "at:2:3:amnesia"},
    {"n_nodes": 64, "n_faulty": 4, "partition": "halves:6"},
    {"n_nodes": 1 << 20, "limits": {"n_nodes": 1 << 20}},
]


@pytest.mark.parametrize("doc", ACCEPTED, ids=lambda d: json.dumps(d)[:40])
def test_jobspec_documents_and_keys_match_jax(doc):
    """Accepted documents: the same to_dict, to_config (field for field),
    from_config round trip, expansion and seed-erased bucket key."""
    doc = dict(doc)
    limits = doc.pop("limits", None)
    t = JobSpec.from_dict(doc, limits=limits)
    j = jjobs.JobSpec.from_dict(doc, limits=limits)
    assert t.to_dict() == j.to_dict()
    tc, jc = t.to_config(), j.to_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert JobSpec.from_config(tc).to_dict() == \
        jjobs.JobSpec.from_config(jc).to_dict()
    assert JobSpec.from_dict(t.to_dict(), limits=limits).to_config() == tc
    assert [s.to_dict() for s in t.expand()] == \
        [s.to_dict() for s in j.expand()]
    for ts, js in zip(t.expand(), j.expand()):
        tk = serve_bucket_key(ts.to_config().replace(seed=123))
        jk = jbatcher.serve_bucket_key(js.to_config())
        assert tk[0] == jk[0]
        assert dataclasses.asdict(tk[1]) == dataclasses.asdict(jk[1])
        assert tk == serve_bucket_key(ts.to_config())


def test_capacity_rungs_match_jax():
    """_capacity_for over one arrival sequence, pool entries added as each
    batch is made (the smallest warm rung that fits, else the next power
    of two, capped)."""
    tb = Batcher(start=False, device="cpu", max_batch_jobs=20)
    jb = jbatcher.Batcher(start=False, max_batch_jobs=20)
    assert tb.max_batch_jobs == jb.max_batch_jobs == 32
    got = {}
    for name, b in (("t", tb), ("j", jb)):
        rungs = []
        for key, n in (("a", 3), ("a", 1), ("b", 1), ("a", 9), ("a", 2),
                       ("a", 32), ("b", 5), ("a", 40), ("b", 4), ("a", 17)):
            cap = b._capacity_for(key, n)
            b._pool.setdefault((key, cap), None)
            rungs.append(cap)
        got[name] = rungs
    assert got["t"] == got["j"] == [4, 4, 1, 16, 4, 32, 8, 32, 8, 32]


def test_stage_model_matches_jax():
    """stage_durations and timing_dict on fixed stamps: complete, raced,
    partial, streamed and never streamed."""
    full = {name: 0.25 * i * i for i, name in enumerate(tjobs.STAGE_STAMPS)}
    raced = {**full, "result_sliced": full["done"] + 5.0}
    partial = {"accepted": 1.0, "validated": 1.5, "enqueued": 1.75}
    unstreamed = {k: v for k, v in full.items() if k != "first_sse"}
    for stamps in (full, raced, partial, unstreamed, {}):
        assert tjobs.stage_durations(stamps) == \
            jjobs.stage_durations(stamps)
        assert tjobs.timing_dict(stamps) == jjobs.timing_dict(stamps)
    for name in ("CONFIG_FIELDS", "JOB_KINDS", "STAGE_STAMPS", "STAGES",
                 "STAGE_NAMES", "SUB_STAGES", "DEFAULT_LIMITS"):
        assert getattr(tjobs, name) == getattr(jjobs, name)
    assert sum(tjobs.stage_durations(full).values()) == \
        pytest.approx(full["done"] - full["accepted"])


# --- the gate ----------------------------------------------------------------


def _baseline():
    with open(os.path.join(ROOT, "SERVE_BASELINE.json")) as fh:
        return json.load(fh)


def _tampered():
    """The committed baseline and its injected regressions and
    incomparabilities (tests/test_serve.py, tests/test_servescope.py)."""
    base = _baseline()

    def edit(**kw):
        m = copy.deepcopy(base)
        for path, v in kw.items():
            *head, last = path.split("__")
            d = m
            for k in head:
                d = d[k]
            d[last] = v
        return m
    qw = base["stages"]["queue_wait"]["p99"]
    ln = base["stages"]["launch"]["p99"]
    return {
        "self": base,
        "queue_wait": edit(stages__queue_wait__p99=qw * 3.0 + 500.0),
        "launch": edit(stages__launch__p99=ln * 3.0 + 500.0),
        "launch_tiny": edit(stages__launch__p99=ln * 3.0),
        "attribution": edit(attribution__ok=False,
                            attribution__coverage=0.4),
        "collapse": edit(jobs_per_launch=1.0, launches=1000),
        "band": edit(jobs_per_launch=base["jobs_per_launch"] * 0.5),
        "errors": edit(errors=3, jobs_completed=997),
        "slow": edit(throughput_jobs_per_sec=1.0,
                     latency_ms__p99=base["latency_ms"]["p99"] * 10),
        "platform": edit(platform="gpu"),
        "scale": edit(scale__n_nodes=64),
        "clients": edit(clients=10),
        "kind": edit(kind="scaling_manifest"),
        "schema": edit(schema_version=1),
    }


def _verdict(mod, manifest, base, **kw):
    try:
        return [f.to_dict() for f in mod.compare_serve(manifest, base, **kw)]
    except mod.IncomparableServe as e:
        return f"incomparable: {e}"


@pytest.mark.parametrize("case", list(_tampered()))
def test_gate_matches_jax(case):
    """compare_serve's findings, messages and refusals equal the JAX
    gate's on every case, with and without a timing band and a lifted
    stage band."""
    base, m = _baseline(), _tampered()[case]
    for kw in ({}, {"timing_band": 0.5}, {"stage_bands": {"queue_wait":
                                                          10.0}}):
        assert _verdict(tgate, m, base, **kw) == \
            _verdict(jgate, m, base, **kw)
    assert (_verdict(tgate, m, base) == []) == \
        (case in ("self", "launch_tiny", "slow"))
    for name in ("COALESCING_BAND", "ATTRIBUTION_BAND", "STAGE_P99_BANDS",
                 "MIN_STAGE_DELTA_MS", "SCHEMA_VERSION"):
        assert getattr(tgate, name) == getattr(jgate, name)


# --- the batcher -------------------------------------------------------------


def test_batcher_round_robin_cancel_and_pad():
    """A job of another bucket gets its own launch next turn; a cancelled
    job is skipped; a partial batch reuses the warm larger rung and counts
    its pad slots; the queue depth is sampled at drain."""
    b = Batcher(start=False, device="cpu", max_batch_jobs=4)
    for s in range(4):
        b.submit_dict({**DYN, "seed": 20 + s})
    assert b.step() == 4 and b.launches == 1
    warm = b.stats()["executors"]
    keep = [b.submit_dict({**DYN, "seed": 30 + s})[0] for s in range(3)]
    gone = b.submit_dict({**DYN, "seed": 40})[0]
    other = b.submit_dict({**DYN, "n_nodes": 24, "seed": 9})[0]
    assert other.bucket != keep[0].bucket
    assert REGISTRY.gauge("serve.queue_depth").value == 5.0
    cancelled0 = REGISTRY.counter("serve.jobs_cancelled").value
    assert gone.cancel() is True and gone.cancel() is False
    assert REGISTRY.counter("serve.jobs_cancelled").value == cancelled0 + 1
    assert sorted((b.step(), b.step())) == [1, 3]
    assert REGISTRY.gauge("serve.queue_depth").value == 0.0
    assert all(j.state == "done" for j in keep + [other])
    assert gone.state == "cancelled" and gone.result is None
    assert ("cancelled", {"job": gone.id}) in gone.events
    assert {j.launch_jobs for j in keep} == {3}
    assert b.stats()["executors"] == warm + 1      # the other bucket only
    assert b.launches == 3 and b.jobs_completed == 8
    assert other.result["mean_k"] == run_point(other.cfg,
                                               device="cpu").mean_k


def test_batch_error_fails_its_jobs_and_the_loop_survives(monkeypatch):
    """A failing batch: its job gets a structured error event, the
    serve.batch_errors counter ticks, the stats carry the snapshot, and
    the thread serves the next job."""
    before = REGISTRY.counter("serve.batch_errors").value
    b = Batcher(device="cpu")
    try:
        def boom(run_cfg, job, dyn):
            raise RuntimeError("injected batch failure")
        monkeypatch.setattr(b, "_run_slot", boom)
        job = b.submit_dict(dict(DYN))[0]
        assert job.wait(timeout=30) and job.state == "error"
        assert job.error == {"error": "RuntimeError: injected batch "
                                      "failure"}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and b.batch_errors < 1:
            time.sleep(0.01)
        st = b.stats()
        assert st["batch_errors"] == 1 and "traceback" in st["last_error"]
        assert REGISTRY.counter("serve.batch_errors").value == before + 1
        monkeypatch.undo()
        ok = b.submit_dict({**DYN, "seed": 55})[0]
        assert ok.wait(timeout=30) and ok.state == "done"
    finally:
        b.close()
    assert not b._thread.is_alive()


def test_batch_and_job_spans(monkeypatch):
    """With tracing on, one batch span flow-linked to its jobs, and each
    job's stage spans nested under its parent span; results equal the
    untraced run."""
    SPANS.clear()
    SPANS.enable()
    try:
        b = Batcher(start=False, device="cpu")
        jobs = [b.submit_dict({**DYN, "seed": 70 + s})[0] for s in range(2)]
        b.step()
        spans = SPANS.snapshot()
    finally:
        SPANS.disable()
        SPANS.clear()
    batch = [s for s in spans if s.track == "serve.batcher"]
    assert len(batch) == 1 and batch[0].args["jobs"] == 2
    assert batch[0].args["pad"] == 0 and batch[0].args["capacity"] == 2
    for job in jobs:
        mine = [s for s in spans if s.track == f"job {job.id}"]
        parent = [s for s in mine if s.parent_id is None]
        assert len(parent) == 1
        assert all(s.parent_id == parent[0].span_id
                   for s in mine if s is not parent[0])
        assert {s.name for s in mine} - {parent[0].name} == \
            set(tjobs.STAGE_NAMES)
        launch = [s for s in mine if s.name == "launch"][0]
        assert launch.flow_in[0] in batch[0].flow_out
    b2 = Batcher(start=False, device="cpu")
    again = [b2.submit_dict({**DYN, "seed": 70 + s})[0] for s in range(2)]
    b2.step()
    assert [_strip(j.result) for j in again] == \
        [_strip(j.result) for j in jobs]


def test_no_card_no_fallback(monkeypatch):
    """Without a CUDA device and without device='cpu' the batcher, the
    app and the load generator raise; nothing moves to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Batcher, ServeApp, lambda: run_load(clients=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# --- the wire: real sockets against a live ServeApp --------------------------


@pytest.fixture(scope="module")
def app():
    with ServeApp(max_batch_jobs=8, device="cpu") as a:
        yield a


def _request(app, payload: bytes, read_until=None,
             timeout: float = 10.0) -> bytes:
    s = socket.create_connection((app.host, app.port), timeout=timeout)
    try:
        s.sendall(payload)
        chunks = b""
        while True:
            got = s.recv(65536)
            if not got:
                break
            chunks += got
            if read_until and read_until in chunks:
                break
    finally:
        s.close()
    return chunks


def _post(app, doc, query: str = "", headers: str = "",
          read_until=None) -> bytes:
    body = json.dumps(doc).encode()
    return _request(app, f"POST /v1/jobs{query} HTTP/1.1\r\nHost: x\r\n"
                         f"{headers}Content-Length: {len(body)}\r\n\r\n"
                         .encode() + body, read_until=read_until)


def _get(app, path: str, headers: str = "") -> bytes:
    return _request(app, f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                         f"{headers}\r\n".encode())


def _status_and_json(resp: bytes):
    head, _, body = resp.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(body)


def _sse(resp: bytes):
    """An SSE response -> [(event, id, data)]."""
    out = []
    for block in resp.partition(b"\r\n\r\n")[2].split(b"\n\n"):
        ev = {}
        for line in block.split(b"\n"):
            k, _, v = line.partition(b": ")
            ev[k] = v
        if b"event" in ev:
            out.append((ev[b"event"].decode(),
                        int(ev[b"id"]) if b"id" in ev else None,
                        json.loads(ev[b"data"])))
    return out


def _wait_done(app, job_id):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        code, snap = _status_and_json(_get(app, f"/v1/jobs/{job_id}"))
        if snap["state"] == "done":
            return snap
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} not done")


def test_http_routes_errors_and_request_ids(app):
    """healthz, stats, 404s, 405, the structured 400s (JobError and a
    body that is not JSON), 413 on the header alone, request-id echo and
    minting, on errors too."""
    resp = _get(app, "/healthz", headers="X-Request-Id: my.id-42\r\n")
    assert _status_and_json(resp) == (200, {"ok": True})
    assert b"X-Request-Id: my.id-42" in resp
    for hdr in ("X-Request-Id: bad id with spaces\r\n", ""):
        head = _get(app, "/healthz", headers=hdr).partition(b"\r\n\r\n")[0]
        assert b"X-Request-Id: r-" in head
    for path in ("/nope", "/v1/jobs/nope", "/v1/jobs/nope/timing"):
        assert _status_and_json(_get(app, path))[0] == 404
    assert _status_and_json(_get(app, "/v1/jobs")) == \
        (405, {"error": "submit jobs with POST"})
    code, body = _status_and_json(_post(app, {"kind": "bogus"}))
    with pytest.raises(jjobs.JobError) as ji:
        jjobs.JobSpec.from_dict({"kind": "bogus"})
    assert code == 400 and body == ji.value.body
    raw = b"not json"
    code, body = _status_and_json(_request(
        app, b"POST /v1/jobs HTTP/1.1\r\nHost: x\r\n"
             b"Content-Length: %d\r\n\r\n" % len(raw) + raw))
    assert code == 400 and body["field"] == "$"
    resp = _request(app, b"POST /v1/jobs HTTP/1.1\r\nHost: x\r\n"
                         b"X-Request-Id: too-big-7\r\n"
                         b"Content-Length: 99999999\r\n\r\n")
    head = resp.partition(b"\r\n\r\n")[0]
    assert head.startswith(b"HTTP/1.1 413")
    assert b"X-Request-Id: too-big-7" in head
    code, stats = _status_and_json(_get(app, "/v1/stats"))
    assert code == 200 and "batch_errors" in stats
    assert stats["max_batch_jobs"] == 8 and "sse_clients" in stats


def test_http_stream_poll_timing_and_cursor(app):
    """A streamed trajectory job: queued, running, the round rows (id =
    the round), the result, one terminal done; its result equals
    run_point.  The same job with since_round=0 or Last-Event-ID: 0 skips
    row 0.  A 202 job polls to done and its timing telescopes; the SSE
    gauge returns to rest, opened and closed paired."""
    g0 = REGISTRY.gauge("serve.sse_clients").value
    opened0 = REGISTRY.counter("serve.sse_opened").value
    doc = {**DYN, "kind": "trajectory", "seed": 52}
    full = _sse(_post(app, doc, query="?stream=sse",
                      read_until=b"event: done"))
    names = [e for e, _, _ in full]
    assert names[:2] == ["queued", "running"] and names[-1] == "done"
    assert names[-2] == "result"
    rounds = [i for e, i, _ in full if e == "round"]
    assert rounds == list(range(len(rounds))) and rounds
    res = full[-2][2]
    cfg = JobSpec.from_dict(doc).to_config()
    assert _strip(res) == _strip(tjobs.result_dict(
        run_point(cfg, device="cpu"), JobSpec.from_dict(doc)))
    for query, hdr in (("?stream=sse&since_round=0", ""),
                       ("?stream=sse", "Last-Event-ID: 0\r\n")):
        again = _sse(_post(app, doc, query=query, headers=hdr,
                           read_until=b"event: done"))
        assert [i for e, i, _ in again if e == "round"] == rounds[1:]
    bad = _post(app, doc, query="?stream=sse&since_round=x")
    assert _status_and_json(bad)[1]["field"] == "since_round"
    code, sub = _status_and_json(_post(app, {**DYN, "seed": 62}))
    assert code == 202 and sub["events"] == [
        f"/v1/jobs/{sub['jobs'][0]}/events"]
    snap = _wait_done(app, sub["jobs"][0])
    assert snap["result"]["job"] == sub["jobs"][0]
    code, timing = _status_and_json(
        _get(app, f"/v1/jobs/{sub['jobs'][0]}/timing"))
    assert code == 200 and timing["state"] == "done"
    assert set(timing["stages_s"]) == set(tjobs.STAGE_NAMES)
    assert timing["total_s"] >= sum(timing["stages_s"].values()) - 5e-6
    events = _sse(_request(app, f"GET /v1/jobs/{sub['jobs'][0]}/events "
                                f"HTTP/1.1\r\nHost: x\r\n\r\n".encode(),
                           read_until=b"event: done"))
    assert [e for e, _, _ in events][-2:] == ["result", "done"]
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and \
            REGISTRY.gauge("serve.sse_clients").value != g0:
        time.sleep(0.01)
    assert REGISTRY.gauge("serve.sse_clients").value == g0
    assert REGISTRY.counter("serve.sse_opened").value - opened0 == 4


def test_http_sweep_stream_and_disconnect(app):
    """A streamed sweep carries every point's result before its one done;
    a client that hangs up before its batch runs frees the slot, and the
    plane keeps serving."""
    doc = {**DYN, "kind": "sweep", "f_values": [1, 4, 7], "seed": 3}
    ev = _sse(_post(app, doc, query="?stream=sse",
                    read_until=b"event: done"))
    results = [p for e, _, p in ev if e == "result"]
    assert [r["n_faulty"] for r in results] == [1, 4, 7]
    assert [e for e, _, _ in ev].count("done") == 1
    # hold the batcher so the disconnected job is still queued
    with app.batcher._cv:
        before = app.batcher.jobs_submitted
        body = json.dumps({**DYN, "seed": 60}).encode()
        s = socket.create_connection((app.host, app.port), timeout=10)
        s.sendall(b"POST /v1/jobs?stream=sse HTTP/1.1\r\nHost: x\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    buf = b""
    while b"event: queued" not in buf:
        buf += s.recv(4096)
    job_id = json.loads([ln for ln in buf.split(b"\n")
                         if ln.startswith(b"data: ")][-1][6:])["job"]
    s.close()
    job = app.batcher.get(job_id)
    assert job.wait(timeout=10)
    assert job.state in ("cancelled", "done")
    assert app.batcher.jobs_submitted == before + 1
    assert _status_and_json(_get(app, "/healthz"))[0] == 200


def test_small_load_manifest(monkeypatch):
    """run_load with a handful of clients on the CPU: every job completes,
    the stages attribute the latency, the manifest is the JAX schema's
    (its checker finds nothing) and names the CPU; against the committed
    1000-client baseline it is incomparable (fewer clients)."""
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema",
        os.path.join(ROOT, "tools", "check_metrics_schema.py"))
    schema = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(schema)
    m = run_load(clients=6, device="cpu", timeout=30, max_batch_jobs=4)
    assert schema.check_serve_manifest(m) == []
    assert (m["platform"], m["device_kind"]) == ("cpu", "cpu")
    assert m["jobs_completed"] == m["jobs_submitted"] == 6
    assert m["errors"] == 0 and m["executor_compiles"] == 0
    assert m["attribution"]["jobs_timed"] == 6 and m["attribution"]["ok"]
    assert m["scale"] == _baseline()["scale"]
    with pytest.raises(tgate.IncomparableServe, match="clients"):
        compare_serve(m, _baseline())
