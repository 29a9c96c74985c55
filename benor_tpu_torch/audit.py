"""Witness rendering (port of benor_tpu/audit.py:211-230): a witness buffer
-> one dict per written (round, trial, node).  The invariant auditor itself
(``audit_witness``, ``WitnessBundle``) waits for the observatory planes
(ROADMAP Queue A item 16); a port buffer is audited by the JAX package's
auditor as it stands."""

from __future__ import annotations

from typing import List

import numpy as np

from .state import WIT_COLUMNS, WIT_WRITTEN


def witness_rows(buffer, trial_ids, node_ids) -> List[dict]:
    """Witness buffer int32 [rounds, W, k, WIT_WIDTH] -> one dict per
    written (round, trial, node) entry, WIT_COLUMNS-keyed (the sentinel
    left out) plus the global "round", "trial" and "node" ids.  Unwritten
    rows (a fresh-buffer resume's gap among them) are skipped by the
    sentinel."""
    if hasattr(buffer, "cpu"):
        buffer = buffer.cpu().numpy()
    buf = np.asarray(buffer).astype(np.int64)
    rows = []
    for r in np.nonzero(buf[:, 0, 0, WIT_WRITTEN] > 0)[0]:
        for wi, t in enumerate(trial_ids):
            for ki, n in enumerate(node_ids):
                d = {"round": int(r), "trial": int(t), "node": int(n)}
                d.update({col: int(v) for col, v
                          in zip(WIT_COLUMNS[:WIT_WRITTEN],
                                 buf[r, wi, ki])})
                rows.append(d)
    return rows
