"""Continuous batching over a pool of warm bucket executors (port of
benor_tpu/serve/batcher.py).

A job's bucket is the sweep engine's bucket token with the seed erased
(``serve_bucket_key``): jobs that share one coalesce into one batch of
the next launch, up to ``max_batch_jobs`` of them, at a capacity rung (1,
2, 4, ... ``max_batch_jobs``) that prefers a warm rung to a new one.  A
bucket and rung is one pool entry (``WarmExecutor``).  Buckets are served
round robin, so a job never waits behind another bucket's backlog for more
than one launch.

How a batch runs on the port (the JAX package runs a dynamic batch as one
vmapped executable):

  * A dynamic bucket's slots run one after another through
    ``sim.run_consensus_traced(rep, state, faults, DynParams)``, with
    ``rep`` the batch's first config at the slot's seed and the slot's own
    DynParams, exactly as the sweep engine runs a dynamic bucket.  The
    batch counts as one launch.  The pad slots of its capacity rung are
    counted and reported (stats, ``serve.batch_pad_ratio``, the batch
    span) and not run: their results were discarded in any case.
  * A quorum-specialized bucket (``sweep.quorum_specialized``: the exact
    tables, the dense top-k mask) runs each job through ``sim.
    run_consensus`` on its own config, one launch a job.
  * Each slot's inputs are run_point's (``jobs.job_inputs``), built just
    before its run, so at most one slot's state is alive at a time; its
    summary goes through ``sweep.point_from_raw``.  A served job therefore
    equals ``sweep.run_point`` of the same config.
  * A warm executor is a pool entry whose kernel library is loaded where
    its configs launch kernels; ``executor_compiles`` counts the library's
    builds and loads (``ops/_build.library_events``), as the sweep
    engine's ``compile_count`` does: 0 on the CPU and once warm.  A served
    job arms no kernel flag (``jobs.CONFIG_FIELDS``), as in the JAX
    package, so it runs the plain loops.

All device work runs on the batcher thread (or the caller of ``step``),
never on the request plane's event loop.  A batch that fails gives each of
its unfinished jobs a structured error and ticks ``serve.batch_errors``;
nothing is rerun on another device.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..config import SimConfig
from ..utils.metrics import REGISTRY, SPANS, perf_to_epoch
from .jobs import STAGES, JobSpec, job_inputs, result_dict

#: Capacity ceiling of one launch (jobs a batch); a power of two, so a
#: bucket has at most log2(MAX_BATCH_JOBS) + 1 capacity rungs.
MAX_BATCH_JOBS = 32


def serve_bucket_key(cfg: SimConfig):
    """The pool bucket of one job config: the sweep engine's bucket token
    with the SEED erased, so jobs that differ only in seed coalesce."""
    from ..sweep import sweep_bucket_key
    kind, c = sweep_bucket_key(cfg)
    return (kind, c.replace(seed=0))


class Job:
    """One batch slot: spec, config and the event stream clients follow.

    Events are (type, payload) tuples appended under the job lock; async
    subscribers (the SSE route) register (loop, asyncio.Event) wakers that
    ``publish`` fires thread-safely; host-side callers block on ``wait``.
    ``cancel`` frees the slot: a queued job turns 'cancelled' and the
    batcher skips it; a running job finishes but its result is discarded.

    ``stamps`` is the stage timeline: one ``perf_counter`` float a
    jobs.STAGE_STAMPS transition, taken whether or not tracing is on (the
    batcher writes accepted through result_sliced and done; the request
    plane refines first_sse and done on the stream leg)."""

    _ids = itertools.count(1)

    def __init__(self, spec: JobSpec, cfg: SimConfig):
        self.spec = spec
        self.cfg = cfg
        self.id = f"j{next(self._ids):05d}-{uuid.uuid4().hex[:8]}"
        self.bucket = serve_bucket_key(cfg)
        self.state = "queued"     # queued|running|done|error|cancelled
        self.result: Optional[dict] = None
        self.error: Optional[dict] = None
        self.events: List[Tuple[str, dict]] = []
        self.stamps: Dict[str, float] = {}
        self.launch_jobs = 0          # batch size of the launch that ran it
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._waiters: List[tuple] = []   # (loop, asyncio.Event)
        self._flow: Optional[int] = None  # batch -> job flow id
        self._spans_emitted = False
        #: True when an SSE stream owns this job's span emission (set
        #: before enqueue, so the publish path cannot race the stream's
        #: waiter registration).
        self._streamed = False

    def stamp(self, name: str, t: Optional[float] = None,
              override: bool = False) -> None:
        """Record a stage transition (the first write wins unless
        ``override``: the stream leg re-stamps ``done`` when delivery, not
        publication, completes)."""
        with self._lock:
            if override or name not in self.stamps:
                self.stamps[name] = (time.perf_counter()
                                     if t is None else t)

    # -- event plane ------------------------------------------------------
    def publish(self, etype: str, payload: dict) -> None:
        with self._lock:
            self.events.append((etype, payload))
            waiters = list(self._waiters)
        if etype in ("done", "error", "cancelled"):
            self._done.set()
        for loop, ev in waiters:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass                      # the subscriber's loop is closed

    def add_waiter(self, loop, ev) -> None:
        with self._lock:
            self._waiters.append((loop, ev))

    def drop_waiter(self, loop, ev) -> None:
        with self._lock:
            try:
                self._waiters.remove((loop, ev))
            except ValueError:
                pass

    @property
    def done(self) -> bool:
        return self.state in ("done", "error", "cancelled")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Host-side completion barrier."""
        return self._done.wait(timeout)

    def cancel(self) -> bool:
        """Free this job's slot (its client went away).  True when the job
        had not reached a launch yet."""
        with self._lock:
            if self.state == "queued":
                self.state = "cancelled"
                freed = True
            else:
                freed = False
        if freed:
            self.publish("cancelled", {"job": self.id})
            REGISTRY.counter("serve.jobs_cancelled").inc()
        return freed


class WarmExecutor:
    """One capacity rung of one bucket: the pool entry (its bucket and
    capacity are its pool key)."""

    def __init__(self, label: str, compile_s: float):
        self.label = label
        #: the kernel library's build and load in this entry's creation
        self.compile_s = compile_s
        self.launches = 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class Batcher:
    """The request queue, the executor pool and the launch loop.

    ``submit`` validates and enqueues; the worker thread (or an explicit
    ``step()``) pops the next non-empty bucket round robin, forms a batch
    of up to ``max_batch_jobs`` live jobs, runs it at its capacity rung on
    ``device`` and publishes each slot's stream and result.  ``device`` is
    resolved by ``sim.resolve_device``: CUDA unless the caller names the
    CPU, and an error with neither."""

    def __init__(self, max_batch_jobs: int = MAX_BATCH_JOBS,
                 limits: Optional[dict] = None, start: bool = True,
                 device=None):
        from ..sim import resolve_device
        if max_batch_jobs < 1:
            raise ValueError("max_batch_jobs must be >= 1")
        self.device = resolve_device(device)
        self.max_batch_jobs = _next_pow2(max_batch_jobs)
        self.limits = limits
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._rr: deque = deque()                 # bucket round robin
        self._pool: Dict[tuple, WarmExecutor] = {}
        self._jobs: Dict[str, Job] = {}
        self._cv = threading.Condition()
        self._stop = False
        self.launches = 0
        self.jobs_completed = 0
        self.jobs_submitted = 0
        self.executor_compiles = 0
        self.batch_errors = 0
        #: Snapshot of the most recent batch failure, served in /v1/stats;
        #: None until something fails.
        self.last_error: Optional[dict] = None
        self._thread = None
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="benor-serve-batcher")
            self._thread.start()

    # -- intake -----------------------------------------------------------
    def submit_dict(self, doc, accepted_t: Optional[float] = None,
                    streamed: bool = False) -> List[Job]:
        """Wire document -> validated, enqueued jobs (a sweep expands to
        one job an f value).  Raises JobError, the structured 400.
        ``accepted_t`` back-dates the accepted stamp to when the request
        plane began on the request; ``streamed`` marks the jobs as owned
        by an SSE stream (``emit_job_spans``)."""
        t_acc = time.perf_counter() if accepted_t is None else accepted_t
        return self.submit(JobSpec.from_dict(doc, limits=self.limits),
                           accepted_t=t_acc, streamed=streamed)

    def submit(self, spec: JobSpec,
               accepted_t: Optional[float] = None,
               streamed: bool = False) -> List[Job]:
        t_acc = time.perf_counter() if accepted_t is None else accepted_t
        jobs = []
        for sub in spec.expand():
            cfg = sub.to_config()         # JobError on invalid combos
            job = Job(sub, cfg)
            job._streamed = streamed
            job.stamp("accepted", t_acc)
            job.stamp("validated")
            jobs.append(job)
        with self._cv:
            for job in jobs:
                self._jobs[job.id] = job
                q = self._queues.get(job.bucket)
                if q is None:
                    q = deque()
                    self._queues[job.bucket] = q
                    self._rr.append(job.bucket)
                q.append(job)
                job.stamp("enqueued")
                self.jobs_submitted += 1
            depth = sum(len(q) for q in self._queues.values())
            self._cv.notify_all()
        REGISTRY.counter("serve.jobs_submitted").inc(len(jobs))
        REGISTRY.gauge("serve.queue_depth").set(depth)
        for job in jobs:
            job.publish("queued", {"job": job.id,
                                   "bucket": job.bucket[0]})
        return jobs

    def get(self, job_id: str) -> Optional[Job]:
        with self._cv:
            return self._jobs.get(job_id)

    # -- launch loop ------------------------------------------------------
    def _pop_batch(self, block: bool, timeout: Optional[float]):
        """Next (bucket, jobs) round robin, cancelled slots skipped."""
        with self._cv:
            while True:
                for _ in range(len(self._rr)):
                    key = self._rr[0]
                    self._rr.rotate(-1)
                    q = self._queues[key]
                    jobs = []
                    while q and len(jobs) < self.max_batch_jobs:
                        job = q.popleft()
                        if job.state == "queued":
                            jobs.append(job)
                    if not q:
                        # drop the empty bucket from the rotation (the
                        # pool keeps its warm entries)
                        del self._queues[key]
                        self._rr.remove(key)
                    if jobs:
                        # queue depth sampled at drain too, so the gauge
                        # shows the batcher catching up
                        depth = sum(len(q) for q in self._queues.values())
                        REGISTRY.gauge("serve.queue_depth").set(depth)
                        return key, jobs
                if not block or self._stop:
                    return None, []
                self._cv.wait(timeout)
                if self._stop:
                    return None, []

    def step(self, block: bool = False,
             timeout: Optional[float] = None) -> int:
        """Process ONE batch (tests drive this; the worker thread loops
        it).  Returns the number of jobs launched."""
        key, popped = self._pop_batch(block, timeout)
        if not popped:
            return 0
        # claim the slots under each job's lock: a client that cancelled
        # between the pop and here keeps its 'cancelled' state
        jobs = []
        t_claim = time.perf_counter()
        for job in popped:
            with job._lock:
                if job.state != "queued":
                    continue
                job.state = "running"
                job.stamps.setdefault("batch_assigned", t_claim)
            jobs.append(job)
        if not jobs:
            return 0
        try:
            self._execute(key, jobs)
        # benorlint: allow-broad-except — multi-tenant boundary: whatever
        # killed this batch reaches ITS clients as error events, and is
        # re-raised for the caller
        except Exception as e:  # noqa: BLE001
            for job in jobs:
                if job.done:
                    continue    # its result already published: keep it
                job.state = "error"
                job.error = {"error": f"{type(e).__name__}: {e}"}
                job.stamp("done")
                job.publish("error", job.error)
            raise
        return len(jobs)

    def _run(self) -> None:
        while not self._stop:
            try:
                self.step(block=True, timeout=0.5)
            # benorlint: allow-broad-except — the failed batch's jobs
            # carry their error events (step's boundary); the worker loop
            # keeps serving every other tenant
            except Exception as e:  # noqa: BLE001
                REGISTRY.counter("serve.batch_errors").inc()
                snap = {
                    "error": f"{type(e).__name__}: {e}",
                    "ts": time.time(),
                    "traceback": traceback.format_exc(limit=20),
                }
                with self._cv:
                    self.batch_errors += 1
                    self.last_error = snap

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- the launch itself ------------------------------------------------
    def _capacity_for(self, key, n_jobs: int) -> int:
        """The capacity rung a batch of ``n_jobs`` runs at: the SMALLEST
        warm rung that fits, else the next power of two, so a ragged
        arrival pattern reuses the warm top rung."""
        want = min(_next_pow2(n_jobs), self.max_batch_jobs)
        warm = sorted(c for (k, c) in self._pool if k == key and c >= want)
        return warm[0] if warm else want

    def _executor(self, key, capacity: int,
                  rep_cfg: SimConfig) -> WarmExecutor:
        """The pool entry of (bucket, capacity), made on first use: the
        kernel library is built or loaded where the entry's config
        launches kernels on the card."""
        from ..ops import _build, tally

        pool_key = (key, capacity)
        ex = self._pool.get(pool_key)
        if ex is not None:
            return ex
        t0 = time.perf_counter()
        events0 = _build.library_events
        if self.device.type == "cuda" and tally.kernels_active(rep_cfg):
            _build.load_library()
        ex = WarmExecutor(f"serve.bucket.{key[0]}.c{capacity}",
                          time.perf_counter() - t0)
        with self._cv:
            # readers (the /v1/stats route) snapshot under the same lock
            self._pool[pool_key] = ex
            self.executor_compiles += _build.library_events - events0
        REGISTRY.counter("serve.executor_builds").inc()
        return ex

    def _run_slot(self, run_cfg: SimConfig, job: Job, dyn: bool):
        """One slot on the device: run_point's inputs for the job, built
        now, then the loop -> (device-side raw point, faults)."""
        from ..sim import run_consensus, run_consensus_traced
        from ..state import DynParams, init_state
        from ..sweep import _raw
        iv, fl = job_inputs(job.cfg, self.device)
        state = init_state(job.cfg, iv, fl)
        if dyn:
            out = run_consensus_traced(
                run_cfg, state, fl,
                DynParams.from_config(job.cfg, self.device))
        else:
            out = run_consensus(run_cfg, state, fl)
        return _raw(run_cfg, out, fl), fl

    def _execute(self, key, jobs: List[Job]) -> None:
        from ..sweep import _barrier, _fetch, point_from_raw

        t_start = time.perf_counter()
        for job in jobs:
            # the state was claimed as 'running' in step(); this is the
            # announcement
            job.publish("running", {"job": job.id, "batch": len(jobs)})
        kind = key[0]
        raws, faults = [], []
        if kind == "dyn":
            capacity = self._capacity_for(key, len(jobs))
            pad = capacity - len(jobs)
            rep = jobs[0].cfg
            ex = self._executor(key, capacity, rep)
            t_launch = time.perf_counter()
            for job in jobs:
                job.stamp("launch_start", t_launch)
            with REGISTRY.timer("serve.launch").time():
                for job in jobs:
                    # the batch's first config at the slot's own seed, with
                    # the slot's F, quorum, committee knobs and drop_prob
                    raw, fl = self._run_slot(
                        rep.replace(seed=job.cfg.seed), job, dyn=True)
                    raws.append(raw)
                    faults.append(fl)
                _barrier(self.device)
                raws = [_fetch(r) for r in raws]      # fetch = barrier
            t_fetched = time.perf_counter()
            for job in jobs:
                job.stamp("launch_end", t_fetched)
            ex.launches += 1
            self.launches += 1
        else:
            # quorum-specialized bucket: one launch a job, on its config
            capacity, pad = 1, 0
            for job in jobs:
                ex = self._executor(key, 1, job.cfg)
                job.stamp("launch_start")
                with REGISTRY.timer("serve.launch").time():
                    raw, fl = self._run_slot(job.cfg, job, dyn=False)
                    raws.append(_fetch(raw))
                faults.append(fl)
                job.stamp("launch_end")
                ex.launches += 1
                self.launches += 1
        launch_s = time.perf_counter() - t_start
        n_launches = 1 if kind == "dyn" else len(jobs)
        REGISTRY.counter("serve.launches").inc(n_launches)
        # occupancy and pad against the dispatched capacity: one padded
        # rung for dyn, len(jobs) capacity-1 launches for a static bucket
        slots = capacity if kind == "dyn" else len(jobs)
        REGISTRY.gauge("serve.batch_occupancy").set(len(jobs) / slots)
        REGISTRY.gauge("serve.batch_pad_ratio").set(pad / slots)
        self._emit_batch_spans(key, jobs, capacity, pad, slots,
                               n_launches, t_start)

        # -- result slices, one a batch slot ------------------------------
        for job, vals, fl in zip(jobs, raws, faults):
            point = point_from_raw(job.cfg, vals, launch_s / len(jobs))
            job.stamp("result_sliced")
            # counted before its result is published, so a client that
            # has read its result never reads a stats snapshot without it
            with self._cv:
                self.jobs_completed += 1
            self._publish_result(job, point, fl, len(jobs))
        done = self.jobs_completed
        REGISTRY.counter("serve.jobs_completed").inc(len(jobs))
        if self.launches:
            REGISTRY.gauge("serve.jobs_per_launch").set(
                done / self.launches)

    def _emit_batch_spans(self, key, jobs: List[Job], capacity: int,
                          pad: int, slots: int, n_launches: int,
                          t_start: float) -> None:
        """One span a drained batch (coalesce window, pad ratio, capacity
        rung, launch count), flow-linked to each job it carried.  No-op
        unless the SPANS plane is enabled."""
        if not SPANS.enabled:
            return
        t_end = time.perf_counter()
        enq = [j.stamps.get("enqueued") for j in jobs]
        enq = [t for t in enq if t is not None]
        # how long the OLDEST slot waited for the batch to form
        coalesce_s = (t_start - min(enq)) if enq else 0.0
        flows = []
        for job in jobs:
            job._flow = SPANS.new_flow()
            flows.append(job._flow)
        SPANS.add(
            f"batch {key[0]} c{capacity}",
            perf_to_epoch(t_start), t_end - t_start,
            track="serve.batcher", flow_out=flows,
            args={"jobs": len(jobs), "capacity": capacity, "pad": pad,
                  "launches": n_launches,
                  "pad_ratio": round(pad / slots, 4),
                  "occupancy": round(len(jobs) / slots, 4),
                  "coalesce_window_s": round(max(0.0, coalesce_s), 6),
                  "queue_depth_at_drain":
                      REGISTRY.gauge("serve.queue_depth").value,
                  "job_ids": [j.id for j in jobs]})

    def _publish_result(self, job: Job, point, faults,
                        batch_jobs: int) -> None:
        """Stream the observability rows, then the result."""
        if job.state == "cancelled":
            return                        # disconnected client: discard
        if point.round_history is not None:
            from ..utils.metrics import round_history_rows
            for row in round_history_rows(point.round_history):
                job.publish("round", row)
        audit_blob = None
        if point.witness is not None:
            from ..audit import WitnessBundle, audit_witness, witness_rows
            from ..state import witness_node_ids
            for row in witness_rows(point.witness,
                                    job.cfg.witness_trials,
                                    witness_node_ids(job.cfg)):
                job.publish("witness", row)
            bundle = WitnessBundle.from_run(job.cfg, point.witness,
                                            faults=faults,
                                            label=f"serve {job.id}")
            report = audit_witness(bundle)
            audit_blob = {"ok": report.ok,
                          "violations": len(report.violations),
                          "summary": report.summary()}
            job.publish("audit", audit_blob)
        res = result_dict(point, job.spec)
        res["job"] = job.id
        res["batch_jobs"] = batch_jobs
        if audit_blob is not None:
            res["audit"] = audit_blob
        job.result = res
        job.launch_jobs = batch_jobs
        job.state = "done"
        job.stamp("done")
        job.publish("result", res)
        job.publish("done", {"job": job.id})
        # a job nobody streams gets its spans here; a streamed one (flag
        # set before enqueue) waits for the stream's last write
        if SPANS.enabled and not job._streamed and not job._waiters:
            emit_job_spans(job)

    # -- stats ------------------------------------------------------------
    def executors_snapshot(self):
        """A consistent [(pool_key, WarmExecutor)] snapshot for readers on
        other threads, taken under the lock the pool's writer holds."""
        with self._cv:
            return list(self._pool.items())

    def stats(self) -> dict:
        with self._cv:
            depth = sum(len(q) for q in self._queues.values())
            return {
                "jobs_submitted": self.jobs_submitted,
                "jobs_completed": self.jobs_completed,
                "queue_depth": depth,
                "launches": self.launches,
                "jobs_per_launch": (self.jobs_completed / self.launches
                                    if self.launches else 0.0),
                "executors": len(self._pool),
                "executor_compiles": self.executor_compiles,
                "buckets_live": len(self._queues),
                "max_batch_jobs": self.max_batch_jobs,
                "batch_errors": self.batch_errors,
                "last_error": self.last_error,
            }


def emit_job_spans(job: Job) -> None:
    """One job's stamp timeline as spans: a whole-job parent span and one
    child span a stage on the job's own track, the launch stage carrying
    the batch's flow link.  At most once a job; no-op with tracing off."""
    if not SPANS.enabled:
        return
    with job._lock:
        if job._spans_emitted:
            return
        job._spans_emitted = True
        stamps = dict(job.stamps)
    acc, done = stamps.get("accepted"), stamps.get("done")
    if acc is None or done is None:
        return
    track = f"job {job.id}"
    parent = SPANS.add(
        f"{job.spec.kind} {job.id}", perf_to_epoch(acc),
        done - acc, track=track,
        args={"bucket": job.bucket[0], "state": job.state,
              "batch_jobs": job.launch_jobs})
    for name, a, b in STAGES:
        if a in stamps and b in stamps:
            SPANS.add(name, perf_to_epoch(stamps[a]),
                      max(0.0, stamps[b] - stamps[a]), track=track,
                      parent_id=parent,
                      flow_in=job._flow if name == "launch" else None)
