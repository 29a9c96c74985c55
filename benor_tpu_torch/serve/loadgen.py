"""Load generator: concurrent SSE clients against the request plane,
reduced to the ``kind: serve_manifest`` document (port of
benor_tpu/serve/loadgen.py).

Each simulated client is one asyncio task holding one real TCP connection:
it POSTs its JobSpec with ``?stream=sse`` and reads the event stream until
the ``done`` event, timing submit-to-result latency end to end
(connection setup included).  Clients get distinct seeds, so the
coalescing they show is the request plane's own (the seed-erased bucket
key).

The manifest (schema version 2, the JAX package's keys) records the client
count, p50/p99/mean/max latency, throughput (completed jobs over the
measured wall), the coalescing efficiency (jobs a launch, from the
server's /v1/stats delta), the per-stage p50/p99/mean blocks
(jobs.STAGE_NAMES, from every job's ``/v1/jobs/<id>/timing`` fetched after
the measured window) and the attribution cross-check: the stage means
must sum to within ``gate.ATTRIBUTION_BAND`` of the client mean latency,
because the stages telescope to the server's accepted -> done total.
``platform`` and ``device_kind`` are ``sim.device_identity``'s: cpu/cpu on
the CPU, as the committed SERVE_BASELINE.json (the JAX package's CPU
capture), and gpu with the card's name on the card.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional

import numpy as np

from ..utils.metrics import REGISTRY
from .gate import ATTRIBUTION_BAND
from .jobs import STAGE_NAMES

#: The default per-client job: a dyn-bucket config (delivery='all',
#: crash faults, uniform scheduler — no quorum-specialized shapes), so
#: concurrent clients coalesce into shared launches.  Small enough that
#: dispatch, not device math, dominates.
DEFAULT_JOB = {"kind": "simulate", "n_nodes": 32, "n_faulty": 4,
               "trials": 8, "max_rounds": 16, "delivery": "all"}

#: Manifest schema version (the JAX package's
#: tools/serve_manifest_schema.json).  v2: per-stage latency blocks and
#: the attribution cross-check.
SCHEMA_VERSION = 2

#: Concurrency ceiling for the post-window timing fetches (one GET per
#: completed job; bounded so the fetch phase is not its own load test).
TIMING_FETCH_CONCURRENCY = 128


def _raise_fd_limit(need: int) -> None:
    """Best-effort RLIMIT_NOFILE bump of this process's own soft limit,
    up to its hard limit: N concurrent clients cost ~2N descriptors
    (client and server side of each socket)."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(hard, max(soft, need))
        if want > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    except (ImportError, ValueError, OSError):
        pass


async def _client(host: str, port: int, body: bytes,
                  timeout: float) -> Dict:
    """One client: POST + SSE read to completion -> {latency_s, ok,
    jobs} — the job ids captured from the stream's ``queued`` events
    feed the post-window ``/v1/jobs/<id>/timing`` attribution fetch."""
    t0 = time.perf_counter()
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError as e:
        return {"ok": False, "error": f"connect: {e}", "jobs": [],
                "latency_s": time.perf_counter() - t0}
    ok, err = False, None
    jobs: List[str] = []
    try:
        writer.write(
            b"POST /v1/jobs?stream=sse HTTP/1.1\r\n"
            b"Host: benor-serve\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        status = await asyncio.wait_for(reader.readline(), timeout)
        if b" 200 " not in status:
            err = f"status {status.decode('latin1').strip()!r}"
            rest = await asyncio.wait_for(reader.read(2048), timeout)
            sep = b"\r\n\r\n"
            if sep in rest:
                body_txt = rest.split(sep, 1)[1].decode()[:200]
                err += f": {body_txt}"
        else:
            deadline = time.perf_counter() + timeout
            pending = None          # event name awaiting its data line
            while True:
                line = await asyncio.wait_for(
                    reader.readline(),
                    max(0.05, deadline - time.perf_counter()))
                if not line:
                    err = "connection closed before done event"
                    break
                if line.startswith(b"event: done"):
                    ok = True
                    break
                if line.startswith(b"event: error"):
                    err = "server error event"
                    break
                if line.startswith(b"event: "):
                    pending = line[len(b"event: "):].strip()
                elif line.startswith(b"data: ") and pending == b"queued":
                    try:
                        jobs.append(json.loads(line[len(b"data: "):])
                                    ["job"])
                    except (ValueError, KeyError):
                        pass
                    pending = None
    except (asyncio.TimeoutError, ConnectionError,
            asyncio.IncompleteReadError) as e:
        err = f"{type(e).__name__}: {e}"
    finally:
        try:
            writer.close()
        except ConnectionError:
            pass
    lat = time.perf_counter() - t0
    REGISTRY.timer("serve.client_latency").record(lat)
    return {"ok": ok, "error": err, "jobs": jobs, "latency_s": lat}


async def _get_json(host: str, port: int, path: str,
                    timeout: float = 10.0) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        # read to EOF (the server sends Connection: close): a single
        # read() returns on the FIRST chunk and a segmented response
        # would hand json.loads a truncated body
        raw = b""
        deadline = time.perf_counter() + timeout
        while True:
            chunk = await asyncio.wait_for(
                reader.read(1 << 16),
                max(0.05, deadline - time.perf_counter()))
            if not chunk:
                break
            raw += chunk
    finally:
        writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


async def _drive(host: str, port: int, clients: int, job: Dict,
                 timeout: float, ramp_s: float) -> Dict:
    stats0 = await _get_json(host, port, "/v1/stats")
    bodies = []
    for i in range(clients):
        doc = dict(job)
        doc["seed"] = int(doc.get("seed", 0)) + i
        bodies.append(json.dumps(doc).encode())
    t0 = time.perf_counter()

    async def one(i):
        if ramp_s:
            # spread connection setup across the ramp so the OS accept
            # queue isn't the thing measured; steady-state concurrency
            # is still `clients` (every client stays connected through
            # its SSE stream)
            await asyncio.sleep(ramp_s * i / max(1, clients))
        return await _client(host, port, bodies[i], timeout)

    results = await asyncio.gather(*(one(i) for i in range(clients)))
    wall = time.perf_counter() - t0
    stats1 = await _get_json(host, port, "/v1/stats")
    # attribution fetch: every completed job's stage timeline, OUTSIDE
    # the measured window (the wall clock above is already closed)
    timings = await _fetch_timings(
        host, port, [j for r in results for j in r["jobs"]])
    return {"results": results, "wall_s": wall,
            "stats0": stats0, "stats1": stats1, "timings": timings}


async def _fetch_timings(host: str, port: int,
                         job_ids: List[str]) -> List[Dict]:
    """GET /v1/jobs/<id>/timing for each id (bounded concurrency);
    unreachable/errored fetches are dropped, not fabricated."""
    sem = asyncio.Semaphore(TIMING_FETCH_CONCURRENCY)

    async def one(jid):
        async with sem:
            try:
                return await _get_json(host, port,
                                       f"/v1/jobs/{jid}/timing")
            except (OSError, ValueError, asyncio.TimeoutError):
                return None
    got = await asyncio.gather(*(one(j) for j in job_ids))
    return [t for t in got if t is not None]


def _stage_blocks(timings: List[Dict], client_mean_ms: float) -> Dict:
    """Per-stage p50/p99/mean blocks (ms) + the attribution cross-check.

    Only fully-attributed timelines count (every jobs.STAGE_NAMES stage
    present — an error job's partial timeline would skew the stage
    population low and break the telescoping identity the cross-check
    rests on); ``jobs_timed`` records the population honestly."""
    full = [t for t in timings
            if all(s in t.get("stages_s", {}) for s in STAGE_NAMES)]
    stages: Dict[str, Dict[str, float]] = {}
    mean_sum = 0.0
    for name in STAGE_NAMES:
        if full:
            arr = np.asarray([t["stages_s"][name] for t in full]) * 1e3
            blk = {"p50": round(float(np.percentile(arr, 50)), 3),
                   "p99": round(float(np.percentile(arr, 99)), 3),
                   "mean": round(float(arr.mean()), 3)}
        else:
            blk = {"p50": 0.0, "p99": 0.0, "mean": 0.0}
        stages[name] = blk
        mean_sum += blk["mean"]
    coverage = (mean_sum / client_mean_ms) if client_mean_ms > 0 else 0.0
    attribution = {
        "jobs_timed": len(full),
        "stage_mean_sum_ms": round(mean_sum, 3),
        "client_mean_ms": round(client_mean_ms, 3),
        "coverage": round(coverage, 4),
        "band": ATTRIBUTION_BAND,
        "ok": bool(full) and abs(coverage - 1.0) <= ATTRIBUTION_BAND,
    }
    return {"stages": stages, "attribution": attribution}


def build_serve_manifest(drive: Dict, clients: int, job: Dict,
                         device=None) -> Dict:
    """Reduce one load run to the pinned-schema manifest document; the
    platform and device kind are ``device``'s (sim.device_identity)."""
    from ..sim import device_identity

    platform, device_kind = device_identity(device)
    results = drive["results"]
    lats_ms = np.asarray([r["latency_s"] for r in results]) * 1e3
    ok = [r for r in results if r["ok"]]
    errors = len(results) - len(ok)
    s0, s1 = drive["stats0"], drive["stats1"]
    jobs_completed = s1["jobs_completed"] - s0["jobs_completed"]
    jobs_submitted = s1["jobs_submitted"] - s0["jobs_submitted"]
    launches = s1["launches"] - s0["launches"]
    scale = {k: job.get(k, DEFAULT_JOB.get(k)) for k in
             ("n_nodes", "n_faulty", "trials", "max_rounds", "delivery")}
    scale["kind"] = job.get("kind", "simulate")
    blocks = _stage_blocks(drive.get("timings", []),
                           float(lats_ms.mean()))
    return {
        "kind": "serve_manifest",
        "schema_version": SCHEMA_VERSION,
        "platform": platform,
        "device_kind": device_kind,
        "clients": clients,
        "jobs_submitted": jobs_submitted,
        "jobs_completed": jobs_completed,
        "errors": errors,
        "duration_s": round(drive["wall_s"], 4),
        "latency_ms": {
            "p50": round(float(np.percentile(lats_ms, 50)), 3),
            "p99": round(float(np.percentile(lats_ms, 99)), 3),
            "mean": round(float(lats_ms.mean()), 3),
            "max": round(float(lats_ms.max()), 3),
        },
        "throughput_jobs_per_sec": round(
            jobs_completed / drive["wall_s"], 3) if drive["wall_s"] else 0.0,
        "launches": launches,
        "jobs_per_launch": round(jobs_completed / launches, 4)
        if launches else 0.0,
        "executor_compiles": s1["executor_compiles"],
        "stages": blocks["stages"],
        "attribution": blocks["attribution"],
        "scale": scale,
    }


def run_load(url: Optional[str] = None, clients: int = 1000,
             job: Optional[Dict] = None, timeout: float = 120.0,
             ramp_s: float = 0.0, max_batch_jobs: Optional[int] = None,
             warmup: bool = True, device=None) -> Dict:
    """Drive a load test -> the serve manifest dict.

    ``url`` targets a running server (``http://host:port``); None starts
    an in-process ServeApp on ``device`` (CUDA unless the caller names the
    CPU) on an ephemeral port for the run, the CLI's default.  ``warmup``
    runs one burst of clients first, so pool entries are made outside the
    measured window.  The manifest names ``device``'s platform.
    """
    from ..sim import resolve_device

    dev = resolve_device(device)
    job = dict(DEFAULT_JOB if job is None else job)
    _raise_fd_limit(2 * clients + 256)
    app = None
    if url is None:
        from .server import ServeApp
        app = ServeApp(max_batch_jobs=max_batch_jobs, device=dev).start()
        host, port = app.host, app.port
    else:
        u = url.split("//", 1)[-1]
        host, _, p = u.partition(":")
        port = int(p.split("/")[0] or 80)
    try:
        if warmup:
            # warm the TOP capacity rung before the measured window: one
            # burst of max_batch_jobs concurrent clients makes the pool
            # entry every later batch reuses (the capacity policy prefers
            # a warm larger rung), so the measurement sees steady-state
            # serving
            stats = asyncio.run(_get_json(host, port, "/v1/stats"))
            burst = int(stats.get("max_batch_jobs", 32))
            wjob = dict(job)
            wjob["seed"] = int(wjob.get("seed", 0)) + clients + 7
            asyncio.run(_drive(host, port, burst, wjob, timeout, 0.0))
        with REGISTRY.timer("serve.load_run").time():
            drive = asyncio.run(_drive(host, port, clients, job,
                                       timeout, ramp_s))
    finally:
        if app is not None:
            app.close()
    manifest = build_serve_manifest(drive, clients, job, device=dev)
    REGISTRY.gauge("serve.load_p99_ms").set(manifest["latency_ms"]["p99"])
    REGISTRY.gauge("serve.load_jobs_per_launch").set(
        manifest["jobs_per_launch"])
    REGISTRY.gauge("serve.load_queue_wait_p99_ms").set(
        manifest["stages"]["queue_wait"]["p99"])
    REGISTRY.gauge("serve.load_attribution_coverage").set(
        manifest["attribution"]["coverage"])
    return manifest
