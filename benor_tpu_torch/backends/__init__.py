"""Backends (the N1 backend switch).

'tpu'     — the device-array simulator (backends/tpu.py): the whole network
            is [trials, N] tensors on the CUDA device (or the CPU when the
            caller asks for it).
'express' — a pure-Python event-loop re-host of the reference's per-node
            servers (backends/express.py): the semantic oracle, quirks and
            all.
'native'  — the same oracle in C++ (backends/native_oracle.py), bit-equal
            to 'express'.

The oracles are host programs in both packages: they take no device.  All
three expose the same observable contract (status / start / stop /
get_state), and ``backends/http_api.py`` serves any of them over HTTP.
"""

from .express import ExpressNetwork
from .tpu import TpuNetwork

__all__ = ["ExpressNetwork", "TpuNetwork"]
