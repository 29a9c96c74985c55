"""meshscope — the live progress plane (port of benor_tpu/meshscope/'s
heartbeat).

  heartbeat  long sliced runs and batched sweeps publish rounds/sec, the
             decided fraction and an ETA between slices and buckets
             (registry gauges and an append-only JSON-lines file that
             ``python -m benor_tpu_torch watch`` tails).

Host-side only, armed by SimConfig.heartbeat_rounds: off and on give the
same results bit for bit.  The JAX package's telemetry, scaling ladders
and their gate wait for distribution (ROADMAP Queue A item 15).
"""

from .heartbeat import (HEARTBEAT_KIND, HeartbeatPublisher,
                        publish_slice_heartbeat, publish_sweep_heartbeat,
                        read_heartbeats, read_records, tail_heartbeats,
                        tail_records)

__all__ = [
    "HEARTBEAT_KIND", "HeartbeatPublisher", "publish_slice_heartbeat",
    "publish_sweep_heartbeat", "read_heartbeats", "read_records",
    "tail_heartbeats", "tail_records",
]
