"""Hypergeometric sampling constants (counterpart of benor_tpu/ops/sampling.py).

Only the regime boundary is ported so far: quorums up to EXACT_TABLE_MAX take
the exact inverse-CDF table in the JAX package, larger ones the
Cornish-Fisher draws the port's kernels implement.  Tests lower it (in both
packages) to force the CF regime at small N.
"""

EXACT_TABLE_MAX = 4096
