"""sweepscope — the batched sweep engine's bucket lifecycle, observed
(port of benor_tpu/sweepscope/).

  journal   the durable sweep journal and exact resume (journal.py);
  spans     per-bucket span trees with flow links to their points
            (spans.py; ``sweep --batched --trace-out``);
  manifest  the ``kind: sweep_manifest`` document: per-bucket stage
            clocks, the serial wall, the ideal-pipeline bound, the
            headroom and the telescoping check (manifest.py;
            ``sweep --batched --manifest-out``);
  gate      the stage model and the stdlib comparator of two manifests
            (gate.py).

Journal and tracing off give the same results and ``library_events`` as
on, and a resumed sweep equals an uninterrupted one.
"""

from .gate import (HEADROOM_BAND, TELESCOPE_MIN, IncomparableSweep,
                   compare_sweep, ideal_pipeline_s, overlap_headroom_s,
                   serial_s)
from .journal import (BUCKET_KIND, DONE_KIND, SweepJournal,
                      bucket_fingerprint, read_journal)
from .manifest import (SWEEP_MANIFEST_KIND, build_sweep_manifest,
                       capture_base_config, capture_f_values,
                       capture_sweep_manifest, default_sweep_scale,
                       load_sweep_manifest, save_sweep_manifest)
from .spans import emit_bucket_spans

__all__ = [
    "HEADROOM_BAND", "TELESCOPE_MIN", "IncomparableSweep",
    "compare_sweep", "ideal_pipeline_s", "overlap_headroom_s",
    "serial_s", "BUCKET_KIND", "DONE_KIND", "SweepJournal",
    "bucket_fingerprint", "read_journal", "SWEEP_MANIFEST_KIND",
    "build_sweep_manifest", "capture_base_config", "capture_f_values",
    "capture_sweep_manifest", "default_sweep_scale",
    "load_sweep_manifest", "save_sweep_manifest", "emit_bucket_spans",
]
