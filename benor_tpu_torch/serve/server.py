"""The asynchronous multi-tenant HTTP and SSE request plane (port of
benor_tpu/serve/server.py).

One asyncio server, many concurrent clients, one batch plane: handlers
validate and enqueue jobs (serve/jobs.py) and stream results back as
server-sent events, the flight recorder's round rows and the witness rows
pushed on the ``since_round`` cursor.  The device work happens on the
batcher thread (serve/batcher.py), so no handler ever waits on the device
on the event loop.

Routes (all JSON unless SSE):

    GET  /healthz                      200 {"ok": true}
    GET  /v1/stats                     batch-plane stats: launches,
                                       jobs-per-launch coalescing ratio,
                                       queue depth, warm-executor pool
    POST /v1/jobs                      submit a JobSpec document.
         ?stream=sse (or Accept: text/event-stream): the response IS the
         job's event stream — queued/running status, ``round`` rows
         (id: = the round cursor), ``witness`` rows, ``audit`` verdict,
         ``result``, ``done``.  Without streaming: 202 with job ids and
         the events URL.  Malformed specs: 400 with the structured
         JobError body (field and reason).
    GET  /v1/jobs/<id>                 job status / result snapshot
    GET  /v1/jobs/<id>/timing          the job's nine-stamp timeline
         reduced to per-stage seconds (jobs.STAGES), stream sub-stages,
         stamps relative to accepted
    GET  /v1/jobs/<id>/events          SSE stream of one job;
         ?since_round=N resumes the round feed past a cursor (rows with
         round <= N are skipped).  Last-Event-ID is the same cursor on
         reconnect.

Every response carries an ``X-Request-Id`` header — the client's own when
it is a sane correlation token, else a minted one — and, with the span
plane armed (``SPANS.enable()``, the CLI's ``--trace-out``), each request
lands as an ``http``-track span beside the batcher's batch and job spans.

A client that disconnects mid-stream frees its batch slot: the read side
of the connection is watched beside the event forwarder, and a closed
socket cancels the job (a queued job leaves the queue; a running one
finishes and its result is discarded).  The routes, bodies, caps and
timeouts are the JAX package's; ``ServeApp(device=...)`` names the
batcher's device.
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..utils.metrics import REGISTRY, SPANS, perf_to_epoch
from .batcher import Batcher, Job, emit_job_spans
from .jobs import JobError, timing_dict

#: Request caps: the request plane parses untrusted bytes.
MAX_HEADERS = 64
MAX_BODY = 1 << 20
READ_TIMEOUT_S = 30.0
#: SSE keepalive cadence while a stream is idle (a comment line, so
#: proxies don't reap the connection and the client can detect liveness).
KEEPALIVE_S = 10.0

_JSON = "application/json"

#: A client-supplied X-Request-Id is echoed VERBATIM only when it looks
#: like a sane correlation token; anything else (header-injection bytes,
#: unbounded length) is replaced by a server-minted id.
_REQ_ID_OK = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")


def _request_id(headers: Dict[str, str]) -> str:
    rid = headers.get("x-request-id", "")
    if _REQ_ID_OK.match(rid):
        return rid
    return f"r-{uuid.uuid4().hex[:16]}"


class _BadRequest(Exception):
    def __init__(self, body: dict, code: int = 400,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(body.get("error", "bad request"))
        self.body = body
        self.code = code
        #: Whatever request headers were parsed before the rejection —
        #: lets the error response still echo the client's
        #: X-Request-Id (the correlation matters MOST on errors).
        self.headers = headers or {}


def _sse_bytes(etype: str, payload, eid=None) -> bytes:
    out = f"event: {etype}\n"
    if eid is not None:
        out += f"id: {eid}\n"
    return (out + f"data: {json.dumps(payload)}\n\n").encode()


class ServeApp:
    """The serving front door: one asyncio server over one Batcher.

    Use as an async context (``await app.start_async()`` inside a
    running loop) or synchronously (``app.start()`` spins a daemon
    thread owning the loop — what the CLI's in-process load mode and the
    tests do).  ``port=0`` binds an ephemeral port, re-read from
    ``app.port`` after start.  ``device`` is the batcher's (CUDA unless
    the caller names the CPU; an error with neither).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 batcher: Optional[Batcher] = None,
                 max_batch_jobs: Optional[int] = None,
                 limits: Optional[dict] = None, device=None):
        self.host = host
        self.port = port
        kw = {} if max_batch_jobs is None else \
            {"max_batch_jobs": max_batch_jobs}
        self.batcher = batcher if batcher is not None else \
            Batcher(limits=limits, device=device, **kw)
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._owns_batcher = batcher is None

    # -- lifecycle --------------------------------------------------------
    async def start_async(self) -> "ServeApp":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        return self

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start_async()
        async with self._server:
            await self._server.serve_forever()

    def start(self) -> "ServeApp":
        """Run the server on a background daemon thread (sync callers)."""
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self.start_async())
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="benor-serve-http")
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("serve plane failed to start")
        return self

    def close(self) -> None:
        if self._loop is not None and self._thread is not None:
            def _stop():
                if self._server is not None:
                    self._server.close()
                self._loop.stop()
            try:
                self._loop.call_soon_threadsafe(_stop)
            except RuntimeError:
                pass
            self._thread.join(timeout=5)
        elif self._server is not None:
            self._server.close()
        if self._owns_batcher:
            self.batcher.close()

    def __enter__(self) -> "ServeApp":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request plumbing -------------------------------------------------
    async def _read_request(self, reader) -> Optional[Tuple]:
        line = await asyncio.wait_for(reader.readline(), READ_TIMEOUT_S)
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) != 3:
            raise _BadRequest({"error": "malformed request line"})
        method, target, _version = parts
        headers: Dict[str, str] = {}
        while True:
            h = await asyncio.wait_for(reader.readline(), READ_TIMEOUT_S)
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= MAX_HEADERS:
                raise _BadRequest({"error": "too many headers"},
                                  headers=headers)
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise _BadRequest({"error": "malformed Content-Length"},
                              headers=headers)
        if length < 0 or length > MAX_BODY:
            raise _BadRequest({"error": "body too large"}, code=413,
                              headers=headers)
        body = b""
        if length:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          READ_TIMEOUT_S)
        url = urlsplit(target)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        return method, url.path, query, headers, body

    async def _respond(self, writer, code: int, body: dict,
                       content_type: str = _JSON,
                       req_id: Optional[str] = None) -> None:
        data = json.dumps(body).encode()
        reason = {200: "OK", 202: "Accepted", 400: "Bad Request",
                  404: "Not Found", 405: "Method Not Allowed",
                  413: "Payload Too Large",
                  500: "Internal Server Error"}.get(code, "OK")
        rid = f"X-Request-Id: {req_id}\r\n" if req_id else ""
        head = (f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(data)}\r\n{rid}"
                f"Connection: close\r\n\r\n")
        writer.write(head.encode() + data)
        await writer.drain()

    async def _handle(self, reader, writer) -> None:
        REGISTRY.counter("serve.http_requests").inc()
        t_req = time.perf_counter()
        rid: Optional[str] = None
        method = path = "?"
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, query, headers, body = req
            rid = _request_id(headers)
            await self._route(reader, writer, method, path, query,
                              headers, body, rid, accepted_t=t_req)
        except _BadRequest as e:
            if rid is None:
                # rejected inside _read_request: the exception carries
                # whatever headers were parsed, so the error response
                # still echoes the client's correlation id (or mints)
                rid = _request_id(e.headers)
            try:
                # drain whatever request bytes are still in flight before
                # replying and closing: responding with unread data
                # pending turns the close into a TCP RST that can discard
                # the error body (matters most for the 413 path, which
                # rejects on the header alone)
                await _drain_reader(reader)
                await self._respond(writer, e.code, e.body, req_id=rid)
            except ConnectionError:
                pass
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError):
            pass
        # benorlint: allow-broad-except — one bad request must never take
        # the request plane down; the failure surfaces to THIS client as
        # a 500 and ticks the serve.http_errors counter
        except Exception as e:  # noqa: BLE001
            REGISTRY.counter("serve.http_errors").inc()
            try:
                await self._respond(
                    writer, 500, {"error": f"{type(e).__name__}: {e}"},
                    req_id=rid or _request_id({}))
            except ConnectionError:
                pass
        finally:
            if SPANS.enabled:
                SPANS.add(f"{method} {path}", perf_to_epoch(t_req),
                          time.perf_counter() - t_req, track="http",
                          args={"request_id": rid or "?"})
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _route(self, reader, writer, method, path, query, headers,
                     body, req_id: Optional[str] = None,
                     accepted_t: Optional[float] = None) -> None:
        if path == "/healthz":
            await self._respond(writer, 200, {"ok": True}, req_id=req_id)
            return
        if path == "/v1/stats":
            await self._respond(writer, 200, self._stats(), req_id=req_id)
            return
        if path == "/v1/jobs":
            if method != "POST":
                raise _BadRequest({"error": "submit jobs with POST"},
                                  code=405)
            await self._submit(reader, writer, query, headers, body,
                               req_id, accepted_t)
            return
        if path.startswith("/v1/jobs/"):
            rest = path[len("/v1/jobs/"):]
            job_id, _, tail = rest.partition("/")
            job = self.batcher.get(job_id)
            if job is None:
                await self._respond(writer, 404,
                                    {"error": f"no job {job_id!r}"},
                                    req_id=req_id)
                return
            if tail == "events":
                since = _since_round(query, headers)
                await self._stream(reader, writer, [job], since, req_id)
            elif tail == "timing":
                await self._respond(writer, 200, _job_timing(job),
                                    req_id=req_id)
            elif tail == "":
                await self._respond(writer, 200, _job_snapshot(job),
                                    req_id=req_id)
            else:
                await self._respond(writer, 404,
                                    {"error": f"no route {path}"},
                                    req_id=req_id)
            return
        await self._respond(writer, 404, {"error": f"no route {path}"},
                            req_id=req_id)

    def _stats(self) -> dict:
        stats = self.batcher.stats()
        stats["executors_detail"] = [
            {"bucket": k[0][0], "capacity": k[1], "launches": ex.launches,
             "compile_s": round(ex.compile_s, 4),
             "label": ex.label}
            for k, ex in sorted(self.batcher.executors_snapshot(),
                                key=lambda kv: kv[1].label)]
        stats["sse_clients"] = REGISTRY.gauge("serve.sse_clients").value
        return stats

    # -- submit + stream --------------------------------------------------
    async def _submit(self, reader, writer, query, headers, body,
                      req_id: Optional[str] = None,
                      accepted_t: Optional[float] = None) -> None:
        # ``accepted`` anchors at HANDLER ENTRY (before the request was
        # even read off the socket), so the validate stage attributes
        # the ingress queueing a loaded event loop imposes between
        # accept and parse — without it, a connect storm's wait is
        # invisible to the stage sum and the attribution cross-check
        # rightly fails
        if accepted_t is None:
            accepted_t = time.perf_counter()
        try:
            doc = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError):
            raise _BadRequest({"error": "invalid job",
                               "field": "$",
                               "reason": "body must be valid JSON"})
        stream = (query.get("stream") == "sse"
                  or "text/event-stream" in headers.get("accept", ""))
        try:
            jobs = self.batcher.submit_dict(doc, accepted_t=accepted_t,
                                            streamed=stream)
        except JobError as e:
            raise _BadRequest(e.body)
        if not stream:
            await self._respond(writer, 202, {
                "jobs": [j.id for j in jobs],
                "bucket": jobs[0].bucket[0],
                "events": [f"/v1/jobs/{j.id}/events" for j in jobs],
            }, req_id=req_id)
            return
        await self._stream(reader, writer, jobs,
                           _since_round(query, headers), req_id)

    async def _stream(self, reader, writer, jobs: List[Job],
                      since_round: Optional[int],
                      req_id: Optional[str] = None) -> None:
        """The SSE leg: forward each job's event feed, racing a watcher
        on the connection's read side so a vanished client cancels its
        jobs instead of holding batch slots."""
        rid = (f"X-Request-Id: {req_id}\r\n" if req_id else "").encode()
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n" + rid +
                     b"Connection: close\r\n\r\n")
        # the client gauge pairs with the finally-side decrement, so the
        # increment must cover EVERY await that can fail (the header
        # drain included — an increment outside this try leaked a
        # phantom client forever on a write failure there); the
        # opened/closed counters are the monotone audit pair the gauge
        # can be cross-checked against
        REGISTRY.gauge("serve.sse_clients").set(
            REGISTRY.gauge("serve.sse_clients").value + 1)
        REGISTRY.counter("serve.sse_opened").inc()
        try:
            await writer.drain()
            forward = asyncio.ensure_future(
                self._forward_events(writer, jobs, since_round))
            watch = asyncio.ensure_future(reader.read(1))
            try:
                done, _pending = await asyncio.wait(
                    {forward, watch}, return_when=asyncio.FIRST_COMPLETED)
                if forward not in done or forward.exception() is not None:
                    # client hung up (or the pipe broke mid-write): free
                    # every batch slot this stream was carrying
                    for job in jobs:
                        job.cancel()
            finally:
                for task in (forward, watch):
                    task.cancel()
                    try:
                        await task
                    except (asyncio.CancelledError, ConnectionError,
                            asyncio.IncompleteReadError):
                        pass
        finally:
            REGISTRY.gauge("serve.sse_clients").set(
                max(0.0, REGISTRY.gauge("serve.sse_clients").value - 1))
            REGISTRY.counter("serve.sse_closed").inc()

    async def _forward_events(self, writer, jobs: List[Job],
                              since_round: Optional[int]) -> None:
        for job in jobs:
            async for etype, payload in _job_events(job, since_round):
                if etype == "ping":
                    writer.write(b": keepalive\n\n")
                elif etype == "done":
                    # per-job completion is implied by its result event;
                    # ONE terminal done closes the whole stream, so a
                    # client reading until `done` gets every slot of a
                    # multi-point sweep, not just the first
                    continue
                else:
                    eid = payload.get("round") if etype == "round" else None
                    writer.write(_sse_bytes(etype, payload, eid=eid))
                await writer.drain()
                if etype in ("round", "witness", "audit", "result"):
                    # the first RESULT-PHASE byte on the wire — the
                    # stream_wait milestone inside stream_out (status
                    # events like queued/running don't count: they
                    # precede the result by construction)
                    job.stamp("first_sse")
            # this job's stream leg is fully written: re-stamp done so
            # stream_out covers SSE delivery, then render its spans
            job.stamp("done", override=True)
            emit_job_spans(job)
        writer.write(_sse_bytes("done", {"jobs": [j.id for j in jobs]}))
        await writer.drain()


async def _drain_reader(reader, cap: int = MAX_BODY,
                        idle_s: float = 0.05) -> None:
    """Best-effort async drain of a request's in-flight bytes (at most
    ``cap``), giving up after ``idle_s`` of quiet — a client awaiting
    the reply costs one short wait, never a stall."""
    drained = 0
    while drained < cap:
        try:
            chunk = await asyncio.wait_for(reader.read(1 << 16), idle_s)
        except asyncio.TimeoutError:
            return
        if not chunk:
            return
        drained += len(chunk)


def _since_round(query, headers) -> Optional[int]:
    raw = query.get("since_round", headers.get("last-event-id"))
    if raw in (None, ""):
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise _BadRequest({"error": "invalid job", "field": "since_round",
                           "reason": "must be an integer round index"})


def _job_snapshot(job: Job) -> dict:
    return {"id": job.id, "state": job.state, "kind": job.spec.kind,
            "bucket": job.bucket[0], "result": job.result,
            "error": job.error,
            "events_url": f"/v1/jobs/{job.id}/events"}


def _job_timing(job: Job) -> dict:
    """GET /v1/jobs/<id>/timing: the job's servescope timeline — each
    stage's attributed seconds, the stream sub-stages when it streamed,
    stamps relative to accepted, and the launch's batch size (how many
    slots amortized the launch this job rode)."""
    with job._lock:
        stamps = dict(job.stamps)
    out = {"job": job.id, "state": job.state, "kind": job.spec.kind,
           "batch_jobs": job.launch_jobs}
    out.update(timing_dict(stamps))
    return out


async def _job_events(job: Job, since_round: Optional[int]):
    """Async iterator over one job's event feed.  Wakes on the batcher
    thread's thread-safe notifications; yields ('ping', None) on idle
    keepalive cadence.  ``since_round`` filters ``round`` rows at or
    below the cursor (the /getRoundHistory contract, pushed)."""
    loop = asyncio.get_running_loop()
    ev = asyncio.Event()
    job.add_waiter(loop, ev)
    idx = 0
    try:
        while True:
            ev.clear()
            n = len(job.events)         # snapshot; list append is atomic
            while idx < n:
                etype, payload = job.events[idx]
                idx += 1
                if (etype == "round" and since_round is not None
                        and payload.get("round", 0) <= since_round):
                    continue
                yield etype, payload
            if job.done and idx >= len(job.events):
                return
            try:
                await asyncio.wait_for(ev.wait(), timeout=KEEPALIVE_S)
            except asyncio.TimeoutError:
                yield "ping", None
    finally:
        job.drop_waiter(loop, ev)


async def _amain(host: str, port: int, max_batch_jobs: Optional[int],
                 verbose: bool = True, device=None) -> None:
    app = ServeApp(host=host, port=port, max_batch_jobs=max_batch_jobs,
                   device=device)
    await app.start_async()
    if verbose:
        import sys
        print(f"benor-serve listening on http://{app.host}:{app.port} "
              f"(POST /v1/jobs, GET /v1/stats; Ctrl-C stops)",
              file=sys.stderr, flush=True)
    try:
        await app.serve_forever()
    finally:
        app.close()


def run_server(host: str = "127.0.0.1", port: int = 8400,
               max_batch_jobs: Optional[int] = None,
               trace_out: Optional[str] = None, device=None) -> int:
    """`python -m benor_tpu_torch serve` body: serve until interrupted.
    ``trace_out`` arms the span plane for the server's lifetime and
    writes the Perfetto trace on shutdown."""
    if trace_out:
        SPANS.enable()
    try:
        asyncio.run(_amain(host, port, max_batch_jobs, device=device))
    except KeyboardInterrupt:
        pass
    finally:
        if trace_out:
            from ..utils.metrics import export_chrome_trace
            import sys
            n = export_chrome_trace(trace_out, spans=True)
            print(f"wrote {n} trace events to {trace_out} "
                  f"(open in ui.perfetto.dev)", file=sys.stderr,
                  flush=True)
    return 0
