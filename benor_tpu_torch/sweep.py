"""Monte-Carlo input distributions (port of benor_tpu/sweep.py:196-208)."""

from __future__ import annotations

import numpy as np


def random_inputs(seed: int, trials: int, n: int) -> np.ndarray:
    """Per-trial random initial bits — the standard MC input distribution."""
    return np.random.default_rng(seed).integers(
        0, 2, size=(trials, n), dtype=np.int8)


def balanced_inputs(trials: int, n: int) -> np.ndarray:
    """Interleaved perfectly-balanced bits (node i starts with i mod 2)."""
    return np.tile((np.arange(n) % 2).astype(np.int8), (trials, 1))
