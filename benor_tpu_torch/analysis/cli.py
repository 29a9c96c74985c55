"""benorlint entry points: run_lint(), the report object, and the
``python -m benor_tpu_torch lint`` subcommand body (port of
benor_tpu/analysis/cli.py).

Exit contract (CI-gateable, same convention as the ``audit``
subcommand): 0 = clean, 2 = findings.  ``--format json`` emits one
machine-readable report document (schema pinned by
tools/check_metrics_schema.LINT_REPORT_SCHEMA); ``--format text`` emits
one ``path:line:col: [rule] message`` block per finding.

Every run feeds the metrics registry (utils/metrics.REGISTRY):
``analysis.runs`` / ``analysis.files`` / ``analysis.findings`` /
``analysis.suppressed`` counters plus the ``analysis.lint`` timer, so
lint cost and outcome land in the same JSON-lines / Prometheus exports
as the kernel library's build accounting.  The lint itself touches no
device and needs none.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from .core import Finding, Project, RULES, run_rules

#: Report schema version (bumped with any key change; the pinned schema
#: lives in tools/check_metrics_schema.py).
REPORT_VERSION = 1


@dataclasses.dataclass
class LintReport:
    """One lint run: findings, per-rule counts, suppression accounting."""

    root: str
    files: int
    rules_run: List[str]
    findings: List[Finding]
    suppressed: Dict[str, int]
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "version": REPORT_VERSION,
            "root": self.root,
            "ok": self.ok,
            "files": self.files,
            "rules_run": list(self.rules_run),
            "findings": [f.to_dict() for f in self.findings],
            "counts": self.counts(),
            "suppressed": dict(self.suppressed),
            "suppressed_total": sum(self.suppressed.values()),
            "elapsed_s": round(self.elapsed_s, 3),
        }

    def to_text(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f"{f.location()}: [{f.rule}] {f.message}")
            if f.hint:
                lines.append(f"    hint: {f.hint}")
        n = len(self.findings)
        sup = sum(self.suppressed.values())
        lines.append(
            f"benorlint: {n} finding{'s' if n != 1 else ''}, {sup} "
            f"suppressed by pragma, {self.files} files, "
            f"{len(self.rules_run)} rules")
        return "\n".join(lines)


def default_root() -> str:
    """The benor_tpu_torch package directory (the lint self-check
    scope)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_lint(root: Optional[str] = None,
             rules: Optional[List[str]] = None) -> LintReport:
    """Lint the package tree under ``root`` (default: benor_tpu_torch/).

    ``rules`` restricts to a subset of registered rule names (tests use
    this to point one family at a fixture tree)."""
    from ..utils.metrics import REGISTRY

    root = default_root() if root is None else os.path.abspath(root)
    t0 = time.perf_counter()
    project = Project(root)
    findings, suppressed = run_rules(project, names=rules)
    elapsed = time.perf_counter() - t0
    report = LintReport(
        root=root, files=len(project.sources),
        rules_run=sorted(RULES if rules is None else rules),
        findings=findings, suppressed=suppressed, elapsed_s=elapsed)
    REGISTRY.counter("analysis.runs").inc()
    REGISTRY.counter("analysis.files").inc(report.files)
    REGISTRY.counter("analysis.findings").inc(len(findings))
    REGISTRY.counter("analysis.suppressed").inc(
        sum(suppressed.values()))
    REGISTRY.timer("analysis.lint").record(elapsed)
    return report


def main(args) -> int:
    """Body of the ``lint`` CLI subcommand (argparse Namespace with
    ``root``, ``format``, ``out``, ``metrics_out``)."""
    report = run_lint(root=args.root)
    doc = report.to_dict()
    text = (json.dumps(doc, indent=1) if args.format == "json"
            else report.to_text())
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote lint report to {args.out}")
    else:
        print(text)
    if getattr(args, "metrics_out", None):
        from ..__main__ import _export_metrics
        _export_metrics(args.metrics_out)
    return 0 if report.ok else 2
