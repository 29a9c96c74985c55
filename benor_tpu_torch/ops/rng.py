"""Stream keys of the port (counterpart of benor_tpu/ops/rng.py).

The main path draws all its randomness from the counter-based threefry
streams of ops/stream.py, keyed on explicit 32-bit key words instead of
``jax.random`` keys.  The ``fold_in`` chain of the JAX module serves the
XLA regimes and the common coin only; it comes with those regimes
(ROADMAP Queue A item 3b).
"""

from __future__ import annotations

# Phase tags: the stream salt of each phase's sampler draws.
PHASE_PROPOSAL = 0
PHASE_VOTE = 1


def key_words(seed: int) -> tuple[int, int]:
    """The two key words ``jax.random.key_data(jax.random.key(seed))`` holds
    for a threefry key: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & 0xFFFFFFFF
