"""Regime config parity: a SimConfig field sim.py consumes must be
visible in every regime (or be allowlisted with a reason) — port of
benor_tpu/analysis/rules_config.py.

The incident this rule owns: the JAX package's observability work added
SimConfig fields one at a time (DynParams' f-axis, ``record``,
``witness_trials``), each hand-threaded through FIVE separately-compiled
regimes — the traced XLA
loop (sim.py), the batched dynamic-F sweep (sweep.py), the fused pallas
round (ops/pallas_round.py), the sharded mesh runner
(parallel/sharded.py) and the multi-host runner (parallel/multihost.py).
A regime that silently ignores a field still runs and still agrees with
itself; only a cross-regime comparison (or a user) notices.  This rule
makes the omission a LINT failure instead: every field ``sim.py`` reads
off ``cfg`` must be referenced in each regime file, or carry an
allowlist entry saying why that regime legitimately never sees it.

The port's regimes are the sweep engine (sweep.py) and the packed round
(ops/packed_round.py, the JAX package's ops/pallas_round.py); the mesh
regimes (parallel/*) wait for ROADMAP Queue A item 15 and are skipped
while absent, as the JAX rule skips any missing regime file.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from .core import Finding, Project, rule

SIM_FILE = "sim.py"
CONFIG_FILE = "config.py"

#: The regimes that must keep parity with sim.py's consumption (a regime
#: file absent from the tree is skipped).
REGIME_FILES = ("sweep.py", "ops/packed_round.py", "parallel/sharded.py",
                "parallel/multihost.py", "parallel/grid.py")

#: (field, regime-file) -> why that regime legitimately never references
#: the field.  Every entry is a REVIEWED delegation argument, not an
#: escape hatch: the reason names the code that covers the regime.
PARITY_ALLOWLIST = {
    # --- the port's regimes ---------------------------------------------
    ("mesh_shape", "sweep.py"):
        "the mesh regimes are ROADMAP Queue A item 15: sim.py refuses "
        "mesh_shape (NotImplementedError) before any regime runs; remove "
        "this entry in the change that ports item 15",
    ("mesh_shape", "ops/packed_round.py"):
        "the mesh regimes are ROADMAP Queue A item 15: sim.py refuses "
        "mesh_shape before either loop runs, and the packed round is "
        "one device's; remove this entry in the change that ports item 15",
    ("n_nodes", "ops/packed_round.py"):
        "the packed round takes the node count from the state it is "
        "handed (n_local = state.x.shape[-1]); sim.simulate reads "
        "cfg.n_nodes only to build the default fault vector at the "
        "harness boundary, from which that state is built",
    ("debug", "sweep.py"):
        "the sweep drives run_consensus/run_consensus_traced, whose "
        "loops emit the debug event themselves (sim._unfused_slice, "
        "packed_round.run_packed_slice)",
    ("debug", "ops/packed_round.py"):
        "run_packed_slice emits the debug event itself, from the "
        "unpacked state after each round (utils/tracing.py); the round "
        "kernels carry no host callback and never see the flag",
    ("seed", "ops/packed_round.py"):
        "the packed loop receives the seed as an argument: sim._slice "
        "passes cfg.seed once at the harness boundary, and every stream "
        "key derives from that argument",
    ("heartbeat_rounds", "ops/packed_round.py"):
        "the heartbeat (meshscope/heartbeat.py) publishes on the host at "
        "slice boundaries, from buffers the slice already returns; the "
        "round kernels never see the cadence — run_packed_slice's caller "
        "(sim.run_consensus_slice) owns the boundary, and the sweep "
        "engine references the field itself",
    ("topology", "ops/packed_round.py"):
        "the round kernels implement the complete graph only; "
        "tally.pallas_round_active rejects structured configs before "
        "dispatch and sim.warn_structured_demotes_pallas announces it",
    ("committee_cap", "ops/packed_round.py"):
        "same structural demotion as topology: committee delivery "
        "requires delivery='all', which the packed loop never serves",
    ("drop_prob", "ops/packed_round.py"):
        "omission requires delivery='all', which the packed loop never "
        "serves (tally.pallas_round_active) — the demotion "
        "sim.warn_faults_demote_pallas announces; the thinning lives in "
        "tally.omission_thin_counts on the unfused loop",
    ("partition", "ops/packed_round.py"):
        "same structural demotion as drop_prob: partitions require "
        "delivery='all', which the packed loop never serves, announced "
        "by sim.warn_faults_demote_pallas",
    # --- the mesh regimes (parallel/*), ROADMAP Queue A item 15 ---------
    # The JAX package's rows, carried as they are: the rule skips these
    # regime files while they are absent, and item 15 reviews each row
    # against the port's mesh runners when it brings them.
    ("debug", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._compiled, whose "
        "_local_slice handles the debug demotion",
    ("seed", "parallel/sharded.py"):
        "same as the fused round: the sharded runner takes the derived "
        "base_key, never the raw seed",
    ("seed", "parallel/multihost.py"):
        "same as the sharded runner; every process derives the identical "
        "base_key from cfg.seed at its own harness boundary",
    ("max_rounds", "parallel/multihost.py"):
        "the round loop (and its cap) lives in sharded._local_slice; "
        "multihost only builds global inputs and dispatches to it",
    ("topology", "parallel/sharded.py"):
        "the adjacency gather runs inside the shared round kernel "
        "(tally.receiver_counts -> topo/deliver.py) via "
        "ctx.all_gather_nodes on global ids — the sharded runner "
        "needs no topology-specific code (tests/test_topo.py)",
    ("topology", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._local_slice, "
        "which reaches the same kernel-level topo dispatch",
    ("committee_cap", "parallel/sharded.py"):
        "committee histograms scatter per shard and psum over the node "
        "axis inside the shared round kernel (models/benor.py -> "
        "topo/committees.py); the sharded runner needs no "
        "committee-specific code",
    ("committee_cap", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._local_slice, "
        "which reaches the same kernel-level committee dispatch",
    ("fault_model", "parallel/sharded.py"):
        "the crash_recover down mask derives inside the shared round "
        "kernel (models/benor.py) and the packed slice "
        "(pallas_round._load_fields) from the FaultSpec bounds — the "
        "sharded runner passes faults through untouched",
    ("fault_model", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._local_slice, "
        "which reaches the same kernel-level fault dispatch",
    ("drop_prob", "parallel/sharded.py"):
        "the binomial thinning runs inside the shared round kernel "
        "(tally.receiver_counts) on psum'd global histograms keyed on "
        "global ids — no sharded-specific code "
        "(tests/test_faults.py pins the mesh bit-identity)",
    ("drop_prob", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._local_slice, "
        "which reaches the same kernel-level omission dispatch",
    ("partition", "parallel/sharded.py"):
        "partition group histograms are per-shard masked sums psum'd "
        "over the node axis inside tally.partition_counts (and the "
        "topo gather masks in topo/deliver.py) — no sharded-specific "
        "code",
    ("partition", "parallel/multihost.py"):
        "multihost delegates the whole loop to sharded._local_slice, "
        "which reaches the same kernel-level partition dispatch",
    ("recovery", "parallel/sharded.py"):
        "the recovery schedule is realized into FaultSpec.recover_round "
        "at the harness boundary (sweep.default_crash_faults); the "
        "compiled regimes read the bounds, and the amnesia rejoin mode "
        "is read where it compiles (models/benor.py, ops/pallas_round)",
    ("recovery", "parallel/multihost.py"):
        "same as the sharded runner: the schedule travels as "
        "FaultSpec.recover_round built at the harness boundary",
    ("debug", "parallel/grid.py"):
        "grid dispatches to run_consensus / run_consensus_sharded, "
        "which apply the debug demotion themselves",
    ("seed", "parallel/grid.py"):
        "grid places the caller's derived base_key (replicated per "
        "GRID_RULES); jax.random.key(cfg.seed) happens at the harness "
        "boundary like every compiled regime",
    ("max_rounds", "parallel/grid.py"):
        "the round loop and its cap live in the delegated runner "
        "(sim.py / parallel/sharded.py); grid only places inputs",
    ("heartbeat_rounds", "parallel/grid.py"):
        "the heartbeat boundary lives in the delegated runner's slice "
        "loop (sim.run_consensus_slice, sharded._local_slice); "
        "placement happens once, before the first slice",
    ("topology", "parallel/grid.py"):
        "the adjacency gather runs inside the shared round kernel "
        "reached through run_consensus_sharded; topology never "
        "changes array shapes, so placement is indifferent to it",
    ("committee_cap", "parallel/grid.py"):
        "same as topology: committee dispatch is kernel-level in the "
        "delegated regime and shape-invariant for placement",
    ("fault_model", "parallel/grid.py"):
        "FaultSpec arrays are placed by GRID_RULES leaf name (faulty/"
        "crash_round/recover_round); their semantics compile in the "
        "delegated round kernel",
    ("drop_prob", "parallel/grid.py"):
        "omission thinning is kernel-level in the delegated regime; "
        "it reads no additional arrays for grid to place",
    ("partition", "parallel/grid.py"):
        "partition masks derive from global node ids inside the "
        "delegated kernel; nothing partition-specific is placed",
    ("recovery", "parallel/grid.py"):
        "the schedule is realized into FaultSpec.recover_round at the "
        "harness boundary; grid places the realized bounds like any "
        "FaultSpec leaf",
}


def _simconfig_fields(project: Project) -> Set[str]:
    """SimConfig dataclass field names + property names, from the AST of
    config.py (never from an import)."""
    src = project.source(CONFIG_FILE)
    fields: Set[str] = set()
    if src is None:
        return fields
    for node in src.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "SimConfig":
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and \
                        isinstance(item.target, ast.Name):
                    fields.add(item.target.id)
                elif isinstance(item, ast.FunctionDef) and any(
                        isinstance(d, ast.Name) and d.id == "property"
                        for d in item.decorator_list):
                    fields.add(item.name)
    return fields


def _attr_uses(project: Project, rel: str, fields: Set[str],
               receiver: str = None) -> Dict[str, int]:
    """field -> first line where ``<receiver>.<field>`` is read in
    ``rel``; any receiver name when ``receiver`` is None."""
    src = project.source(rel)
    uses: Dict[str, int] = {}
    if src is None:
        return uses
    for node in src.nodes:
        if not isinstance(node, ast.Attribute) or \
                node.attr not in fields:
            continue
        if receiver is not None and not (
                isinstance(node.value, ast.Name) and
                node.value.id == receiver):
            continue
        if node.attr not in uses or node.lineno < uses[node.attr]:
            uses[node.attr] = node.lineno
    return uses


@rule("config-parity", "config",
      "SimConfig fields consumed in sim.py must reach every regime")
def check_config_parity(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    fields = _simconfig_fields(project)
    if not fields or project.source(SIM_FILE) is None:
        return findings
    consumed = _attr_uses(project, SIM_FILE, fields, receiver="cfg")
    regime_refs = {rel: _attr_uses(project, rel, fields)
                   for rel in REGIME_FILES if project.source(rel)}
    for field in sorted(consumed):
        for rel, refs in regime_refs.items():
            if field in refs:
                continue
            if (field, rel) in PARITY_ALLOWLIST:
                continue
            findings.append(Finding(
                "config-parity", SIM_FILE, consumed[field], 0,
                f"SimConfig.{field} is consumed by the entry points (sim.py) "
                f"but never referenced in the {rel} regime — a "
                f"recorder-style feature that silently skips a regime "
                f"still runs and still agrees with itself",
                hint=f"thread the field through {rel}, or add "
                     f"('{field}', '{rel}') to "
                     f"analysis.rules_config.PARITY_ALLOWLIST with the "
                     f"delegation argument"))
    return findings
