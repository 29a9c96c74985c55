"""The science deliverables (port of benor_tpu/results.py).  Only
``topo_curves`` (results.py:731-761) is ported; the rest of the module —
the presets, the studies, the RESULTS writer — is ROADMAP Queue A item 14.
"""

from __future__ import annotations

from typing import Dict

from .config import SimConfig


def topo_curves(n: int, trials: int, seed: int = 0,
                max_rounds: int = 32, verbose: bool = False,
                device=None) -> Dict:
    """The structured-delivery science rows: rounds-to-decide against
    degree and diameter over the default ring / torus / random-regular
    ladder (the neighbourhood-unanimity bar, topo/curves.unanimity_fault),
    and the committee-size sweep at committee count 4, one dynamic bucket,
    whose build count rides the return."""
    from .topo.curves import (committee_curve, default_degree_specs,
                              degree_curve)

    base = SimConfig(n_nodes=n, n_faulty=0, trials=trials,
                     max_rounds=max_rounds, seed=seed)
    deg_rows = degree_curve(base, default_degree_specs(n),
                            verbose=verbose, device=device)
    # sizes stay <= N / committee_count: past it the participation
    # probability clips at 1 and every size draws the same membership
    sizes = sorted({max(2, n // 16), max(3, n // 8), max(4, n // 4)})
    com_rows, cb = committee_curve(base.replace(n_faulty=1), sizes=sizes,
                                   committee_count=4, verbose=verbose,
                                   device=device)
    return {"degree_curve": deg_rows, "committee_curve": com_rows,
            "committee_compile_count": cb.compile_count,
            "committee_buckets": cb.n_buckets}
