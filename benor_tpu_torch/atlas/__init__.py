"""atlas, the phase-boundary observatory (port of benor_tpu/atlas).

A scenario search driver (``atlas.search``) with the batched engine
(``sweep.run_points_batched``) as its evaluator and the auditor
(``audit.py``) as its oracle, hunting safety and liveness boundaries
along one knob at a time; the axis grammar (``atlas.scenario``); the
minimal-repro emitter whose ``kind: atlas_repro`` documents replay bit
for bit (``atlas.repro``, ``python -m benor_tpu_torch replay``); the
``kind: atlas_manifest`` capture (``atlas.manifest``); and the
stdlib-only cliff-drift comparator (``atlas.gate``) the committed
``ATLAS_BASELINE.json`` is held to.  The documents are the JAX
package's, so a repro or a manifest made by one package is read by the
other.

This module stays import-light: the record tags and the heatmap
renderer need no torch, and the submodules load on first use.
"""

from __future__ import annotations

#: One evaluated probe (axis value -> verdict), appended to the search
#: journal among the sweep journal's bucket records.
PROBE_KIND = "atlas_probe"

#: One refinement step of a detected cliff's bracketing interval.
CLIFF_KIND = "atlas_cliff"

#: One evaluated 2D slice (rounds-to-decide / stall-frac heatmap rows).
HEATMAP_KIND = "atlas_heatmap"

_SUBMODULES = ("scenario", "search", "repro", "manifest", "gate")

__all__ = ["PROBE_KIND", "CLIFF_KIND", "HEATMAP_KIND",
           "render_heatmap", *_SUBMODULES]

#: Terminal shade ramp for render_heatmap (metric 0 -> row max).
_SHADES = " .:-=+*#%@"


def render_heatmap(doc: dict, metric: str = "stall_frac") -> str:
    """Terminal rendering of one ``kind: atlas_heatmap`` document: one row
    per axis_b value, one shade cell per axis_a value (darkest = the
    slice maximum)."""
    va, vb = doc["values_a"], doc["values_b"]
    cell = {(r["a"], r["b"]): float(r[metric]) for r in doc["rows"]}
    top = max(max(cell.values(), default=0.0), 1e-12)
    lines = [f"atlas heatmap: {metric} over "
             f"{doc['axis_a']} (->) x {doc['axis_b']} (rows)"]
    for b in vb:
        shades = ""
        for a in va:
            frac = min(max(cell.get((a, b), 0.0) / top, 0.0), 1.0)
            shades += _SHADES[int(round(frac * (len(_SHADES) - 1)))]
        lines.append(f"  {doc['axis_b']}={b:<8g} |{shades}|")
    lines.append(f"  {doc['axis_a']}: {va[0]:g} .. {va[-1]:g}   "
                 f"(shade ' '..'@' = {metric} 0..{top:g})")
    return "\n".join(lines)


def __getattr__(name: str):
    # the submodules load on first use (search, repro and manifest import
    # the sweep engine, and with it torch)
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
