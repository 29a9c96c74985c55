"""The dense path's exact tally from an explicit delivery mask
(port of benor_tpu/ops/pallas_tally.py, ``dense_counts_pallas``).

    counts[t, r, c] = #{s : mask[t, r, s] and alive[t, s] and sent[t, s] == c}

``dense_counts`` launches the hand-written CUDA kernel
(csrc/tally_kernels.cu) for CUDA operands and counts the launch in its
``launches`` attribute; for CPU operands it runs ``dense_counts_plain``,
which the tests hold against the JAX package's Pallas kernel in interpret
mode and ``chip_smoke.py`` holds against the kernel on the card.  Any other
device raises.  Both are integer sums, so they agree exactly.
"""

from __future__ import annotations

import torch

from ..config import VAL0, VAL1, VALQ
from .launch import check, on_cpu, ptr, raise_on, stream

#: Edges one pass of the plain version masks at a time (one bool each).
PLAIN_CHUNK = 1 << 26


def dense_counts_plain(mask: torch.Tensor, sent: torch.Tensor,
                       alive: torch.Tensor) -> torch.Tensor:
    """Plain version of the tally kernel -> int32 [T, R, 3]: exact integer
    sums of ``mask & alive & (sent == c)`` over the senders, in passes over
    the receivers so only a bool [T, rows, S] is ever made beside the
    mask."""
    t, n_recv, n_send = mask.shape
    out = torch.empty((t, n_recv, 3), dtype=torch.int32, device=mask.device)
    classes = [(alive & (sent == v))[:, None, :] for v in (VAL0, VAL1, VALQ)]
    step = max(1, PLAIN_CHUNK // max(t * n_send, 1))
    for lo in range(0, n_recv, step):
        rows = mask[:, lo:lo + step]
        for c, cls in enumerate(classes):
            out[:, lo:lo + step, c] = (rows & cls).sum(-1, dtype=torch.int32)
    return out


def _launch_dense_counts(lib, mask, sent, alive):
    t, n_recv, n_send = mask.shape
    out = torch.empty((t, n_recv, 3), dtype=torch.int32, device=mask.device)
    raise_on(lib.benor_dense_counts(ptr(mask), ptr(sent), ptr(alive),
                                    ptr(out), t, n_recv, n_send,
                                    stream(mask.device)), "dense_counts")
    return out


def dense_counts(mask: torch.Tensor, sent: torch.Tensor,
                 alive: torch.Tensor) -> torch.Tensor:
    """Exact per-receiver class counts -> int32 [T, R, 3].  ``mask``: bool
    [T, R, S] delivery mask; ``sent``: int8 [T, S] sender values (a value
    outside {0, 1, 2} counts nowhere); ``alive``: bool [T, S]."""
    if on_cpu(mask.device, "dense_counts"):
        return dense_counts_plain(mask, sent, alive)
    from ._build import load_library

    t, _, n_send = mask.shape
    # the [T, S] sender vectors may be broadcast views; the mask is used as
    # it is (a copy would double the path's largest tensor)
    sent, alive = sent.contiguous(), alive.contiguous()
    check("mask", mask, torch.bool, mask.shape, mask.device)
    check("sent", sent, torch.int8, (t, n_send), mask.device)
    check("alive", alive, torch.bool, (t, n_send), mask.device)
    out = _launch_dense_counts(load_library(), mask, sent, alive)
    dense_counts.launches += 1
    return out


dense_counts.launches = 0

#: The kernel wrapper, by name (its launch counter is ``.launches``).
KERNELS = {"dense_counts": dense_counts}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
