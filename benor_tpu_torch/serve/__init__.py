"""benor-serve: the asynchronous multi-tenant request plane over a pool of
warm bucket executors (port of benor_tpu/serve/).

  jobs.py     the job API — JobSpec -> SimConfig -> bucket -> batch slot
              -> result slice (the CLI and the HTTP plane consume it)
  batcher.py  continuous batching: bucket queues, the pool of warm
              executors (seed-erased sweep buckets, capacity rungs)
  server.py   the asyncio HTTP and SSE front door (ServeApp); streams the
              flight recorder's round rows and the witness rows on the
              ``since_round`` cursor
  loadgen.py  concurrent SSE clients -> the ``kind: serve_manifest``
              document (p50/p99 latency, throughput, jobs a launch, the
              stage attribution)
  gate.py     the standard-library manifest comparator behind ``load``
              and the committed SERVE_BASELINE.json

Every job carries the nine-stamp stage timeline (jobs.STAGE_STAMPS); the
batcher and the front door emit batch, job and request spans into
``utils.metrics.SPANS`` when tracing is armed.  A served job equals
``sweep.run_point`` of the same config.  Importing this package touches
no device; the device work begins at the first batch, on the batcher
thread.
"""

from .batcher import (MAX_BATCH_JOBS, Batcher, Job, emit_job_spans,
                      serve_bucket_key)
from .gate import (ATTRIBUTION_BAND, COALESCING_BAND, STAGE_P99_BANDS,
                   IncomparableServe, ServeFinding, compare_serve)
from .jobs import (CONFIG_FIELDS, JOB_KINDS, STAGE_NAMES, STAGE_STAMPS,
                   STAGES, JobError, JobSpec, job_inputs, result_dict,
                   stage_durations, timing_dict)
from .loadgen import DEFAULT_JOB, build_serve_manifest, run_load
from .server import ServeApp, run_server

__all__ = [
    "MAX_BATCH_JOBS", "Batcher", "Job", "emit_job_spans",
    "serve_bucket_key", "ATTRIBUTION_BAND", "COALESCING_BAND",
    "STAGE_P99_BANDS", "IncomparableServe", "ServeFinding",
    "compare_serve", "CONFIG_FIELDS", "JOB_KINDS", "STAGE_NAMES",
    "STAGE_STAMPS", "STAGES", "JobError", "JobSpec", "job_inputs",
    "result_dict", "stage_durations", "timing_dict", "DEFAULT_JOB",
    "build_serve_manifest", "run_load", "ServeApp", "run_server",
]
