"""The sweep engine's durable journal and its stage-clock model (port of
benor_tpu/sweepscope/journal.py and the four pipeline functions of
benor_tpu/sweepscope/gate.py).  The manifests, ``compare_sweep`` and the
per-bucket spans wait for the observatory planes (ROADMAP Queue A item
16)."""
