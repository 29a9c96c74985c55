"""Backends (the N1 backend switch).

'tpu' — the device-array simulator (backends/tpu.py): the whole network is
        [trials, N] tensors on the CUDA device.

The JAX package's event-loop oracles ('express', 'native') and its HTTP
layer are not ported (ROADMAP Queue A item 17).
"""

from .tpu import TpuNetwork

__all__ = ["TpuNetwork"]
