"""The regimes as capturable workloads (port of
benor_tpu/perfscope/regimes.py).

Each regime the port runs, built at a profile scale, captured stage by
stage (capture.py) and reduced to one PerfReport.  ``capture_all`` is what
``python -m benor_tpu_torch profile`` runs.

Regime configs (balanced inputs, zero crashes, the JAX package's):

  traced         uniform scheduler, f = 0.4 N, the unfused loop
  fused_pallas   the count-controlling adversary and the common coin with
                 ``use_pallas_round``: closed-form counts, so the round
                 kernels serve at any scale (the plain versions on the
                 CPU) and share every random bit with the unfused loop
  sliced         the traced config through ``run_consensus_slice``, one
                 slice over ``[1, max_rounds + 2)``
  batched_sweep  two dynamic-F points of the adversarial config through
                 ``run_consensus_traced`` with their ``DynParams``, one
                 after another, as the port's sweep engine runs a dynamic
                 bucket, each reduced by ``summarize_final``
  sharded        not ported (ROADMAP Queue A item 15): it raises

The profile scale is 256 x 8 x 12 on the CPU and the main path's
1,000,000 x 32 (max_rounds 16) on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import unported

#: Manifest regime keys, capture order (the JAX package's five).
REGIME_NAMES = ("traced", "fused_pallas", "sliced", "batched_sweep",
                "sharded")

#: Regimes the port does not capture yet -> their ROADMAP Queue A item.
UNPORTED_REGIMES = {"sharded": "15"}

#: The regimes the port captures, in capture order.
PORTED_REGIMES = tuple(r for r in REGIME_NAMES
                       if r not in UNPORTED_REGIMES)


def default_profile_scale(device=None) -> dict:
    """(n_nodes, trials, max_rounds) of a profile capture: the JAX
    package's CPU scale on the CPU, the main path's N = 1M x 32 on the
    card."""
    from ..sim import resolve_device

    if resolve_device(device).type == "cpu":
        return {"n_nodes": 256, "trials": 8, "max_rounds": 12}
    return {"n_nodes": 1_000_000, "trials": 32, "max_rounds": 16}


def _even_quorum(n: int, f: int) -> int:
    """F adjusted so the quorum N - F is even (the tie-forcing adversary's
    requirement)."""
    return f + (n - f) % 2


def _uniform_cfg(n: int, trials: int, max_rounds: int, seed: int):
    from ..config import SimConfig
    return SimConfig(n_nodes=n, n_faulty=int(0.4 * n), trials=trials,
                     delivery="quorum", scheduler="uniform",
                     path="histogram", max_rounds=max_rounds, seed=seed)


def _adversarial_cfg(n: int, trials: int, max_rounds: int, seed: int,
                     use_pallas_round: bool = False):
    from ..config import SimConfig
    return SimConfig(n_nodes=n, n_faulty=_even_quorum(n, int(0.2 * n)),
                     trials=trials, delivery="quorum",
                     scheduler="adversarial", coin_mode="common",
                     path="histogram", max_rounds=min(12, max_rounds),
                     use_pallas_round=use_pallas_round, seed=seed)


def balanced_start(cfg, device):
    """The balanced inputs' start state and no faults, on ``device``."""
    from ..state import FaultSpec, init_state
    from ..sweep import balanced_inputs

    faults = FaultSpec.none(cfg.trials, cfg.n_nodes, device=device)
    state = init_state(cfg, balanced_inputs(cfg.trials, cfg.n_nodes),
                       faults)
    return state, faults


def _scale(n_nodes, trials, max_rounds, device):
    scale = default_profile_scale(device)
    return (scale["n_nodes"] if n_nodes is None else n_nodes,
            scale["trials"] if trials is None else trials,
            scale["max_rounds"] if max_rounds is None else max_rounds)


def capture_regime(name: str, *, n_nodes: Optional[int] = None,
                   trials: Optional[int] = None,
                   max_rounds: Optional[int] = None, seed: int = 0,
                   steady_reps: int = 2, device=None,
                   profile: bool = True):
    """Capture ONE regime -> (PerfReport, the outputs of its first
    execution): ``run_consensus``'s (rounds, final state) for traced and
    fused_pallas, ``run_consensus_slice``'s (next round, state) for sliced,
    and for batched_sweep the JAX bucket runner's (rounds, decided_frac,
    mean_k, ones_frac, k_hist, disagree_frac, final state), each stacked
    over the points.  ``profile``: the profiler pass on the card."""
    from ..ops import tally
    from ..sim import resolve_device
    from .capture import build_report, capture_stages

    if name in UNPORTED_REGIMES:
        unported(f"the {name!r} profile regime (a mesh run)",
                 UNPORTED_REGIMES[name])
    if name not in REGIME_NAMES:
        raise ValueError(f"unknown regime {name!r}; choose from "
                         f"{REGIME_NAMES}")
    dev = resolve_device(device)
    n, t, mr = _scale(n_nodes, trials, max_rounds, dev)
    stages = dict(steady_reps=steady_reps, profile=profile)

    if name in ("traced", "fused_pallas", "sliced"):
        from ..sim import run_consensus, run_consensus_slice, start_state
        cfg = (_adversarial_cfg(n, t, mr, seed, use_pallas_round=True)
               if name == "fused_pallas" else _uniform_cfg(n, t, mr, seed))
        if name == "fused_pallas" and not tally.pallas_round_active(cfg):
            raise ValueError(
                "fused_pallas regime config failed the kernel gate "
                "(pallas_round_active) — the capture would silently "
                "profile the XLA loop instead")
        state, faults = balanced_start(cfg, dev)
        if name == "sliced":
            st = start_state(cfg, state)
            bounds = (1, cfg.max_rounds + 2)

            def run():
                return run_consensus_slice(cfg, st, faults, *bounds)
            args = (st, faults)
        else:
            def run():
                return run_consensus(cfg, state, faults)
            args = (state, faults)
        cap = capture_stages(f"regime.{name}", run, args, dev,
                             needs_library=tally.kernels_active(cfg),
                             **stages)
        rounds = int(cap.out[0]) - (1 if name == "sliced" else 0)
        extra = {"scheduler": cfg.scheduler}
        if name == "sliced":
            extra["slice_bounds"] = list(bounds)
        else:
            extra["coin_mode"] = cfg.coin_mode
        if name == "fused_pallas":
            extra["use_pallas_round"] = True

    else:                                   # batched_sweep
        from ..sim import run_consensus_traced
        from ..state import DynParams, FaultSpec, NetState, init_state
        from ..sweep import balanced_inputs, summarize_final, sweep_bucket_key
        base = _adversarial_cfg(n, t, mr, seed)
        f_values = [_even_quorum(n, int(0.15 * n)),
                    _even_quorum(n, int(0.25 * n))]
        cfgs = [base.replace(n_faulty=f) for f in f_values]
        if any(sweep_bucket_key(c)[0] != "dyn" for c in cfgs):
            raise ValueError(
                "batched_sweep regime points fell into a static bucket — "
                "the capture would not cover the dynamic-F executable")
        bal = balanced_inputs(t, n)
        fls = [FaultSpec.none(t, n, device=dev) for _ in f_values]
        states = [init_state(c, bal, fl) for c, fl in zip(cfgs, fls)]
        dyn = DynParams.stack(cfgs, dev)
        cfg = cfgs[0]

        def run():
            outs = []
            for j, (st, fl) in enumerate(zip(states, fls)):
                r, fin = run_consensus_traced(cfg, st, fl, dyn.at(j))[:2]
                outs.append((torch.as_tensor(r, dtype=torch.int32,
                                             device=dev),
                             *summarize_final(fin, fl.faulty,
                                              cfg.max_rounds), fin))
            cols = list(zip(*outs))
            fins = cols.pop()
            stacked = NetState(*(torch.stack([getattr(f, a) for f in fins])
                                 for a in ("x", "decided", "k", "killed")))
            return (*(torch.stack(c) for c in cols), stacked)

        cap = capture_stages(f"regime.{name}", run, (states, fls, dyn), dev,
                             **stages)
        rounds = int(cap.out[0].max())
        extra = {"scheduler": base.scheduler, "f_values": list(f_values),
                 "batch": len(f_values)}

    return build_report(name, cfg, cap, rounds, dev, extra=extra), cap.out


def capture_fused_vs_xla(n_nodes: Optional[int] = None,
                         trials: Optional[int] = None,
                         max_rounds: Optional[int] = None, seed: int = 0,
                         steady_reps: int = 2, device=None,
                         profile: bool = True) -> dict:
    """The paired measurement behind the manifest's ``fused_vs_xla`` block
    (regimes.py:230-311): one config run through ``run_consensus`` with
    ``use_pallas_round`` on (the packed loop, the round kernels) and off
    (the unfused loop, the "xla" leg) on identical inputs, bit-compared
    and timed; ``speedup`` is the unfused leg's steady seconds over the
    packed leg's.  The uniform CF config where the kernel gate admits it
    (its unfused leg keeps ``use_pallas_hist``, the path that shares the
    kernels' streams), else the count-controlling adversary.
    ``interpret_mode`` marks a CPU capture, where the plain versions
    stand in for the kernels."""
    from ..ops import tally
    from ..ops.packed_round import fused_one_pass_eligible
    from ..sim import resolve_device, run_consensus
    from .capture import capture_stages
    from .roofline import packing_report

    dev = resolve_device(device)
    n, t, mr = _scale(n_nodes, trials, max_rounds, dev)
    cfg_fused = _uniform_cfg(n, t, mr, seed).replace(
        use_pallas_hist=True, use_pallas_round=True)
    if not tally.pallas_round_active(cfg_fused):
        cfg_fused = _adversarial_cfg(n, t, mr, seed, use_pallas_round=True)
    if not tally.pallas_round_active(cfg_fused):
        raise ValueError(
            "fused_vs_xla pair config failed the kernel gate "
            "(pallas_round_active) — both legs would time the XLA loop")
    cfg_xla = cfg_fused.replace(use_pallas_round=False)
    state, faults = balanced_start(cfg_fused, dev)
    caps = {}
    for label, cfg in (("fused", cfg_fused), ("xla", cfg_xla)):
        caps[label] = capture_stages(
            f"fused_vs_xla.{label}",
            lambda cfg=cfg: run_consensus(cfg, state, faults),
            (state, faults), dev, needs_library=tally.kernels_active(cfg),
            steady_reps=steady_reps, profile=profile)
    rounds_f = int(caps["fused"].out[0])
    rounds_x = int(caps["xla"].out[0])
    bit_equal = rounds_f == rounds_x and all(
        torch.equal(getattr(caps["fused"].out[1], a),
                    getattr(caps["xla"].out[1], a))
        for a in ("x", "decided", "k", "killed"))
    fused_s = caps["fused"].steady_execute_s
    xla_s = caps["xla"].steady_execute_s
    return {
        "n_nodes": cfg_fused.n_nodes,
        "trials": cfg_fused.trials,
        "max_rounds": cfg_fused.max_rounds,
        "rounds_executed": rounds_f,
        "bit_equal": bool(bit_equal),
        "interpret_mode": dev.type == "cpu",
        "counts_mode": tally.pallas_round_counts_mode(cfg_fused),
        "one_pass": fused_one_pass_eligible(cfg_fused, cfg_fused.trials,
                                            cfg_fused.n_nodes),
        "baseline_path": ("pallas_hist" if cfg_xla.use_pallas_hist
                          else "xla"),
        "fused_steady_execute_s": round(fused_s, 6),
        "xla_steady_execute_s": round(xla_s, 6),
        "speedup": (round(xla_s / fused_s, 4) if fused_s > 0 else None),
        **packing_report(cfg_fused.max_rounds),
    }


def capture_all(n_nodes: Optional[int] = None,
                trials: Optional[int] = None,
                max_rounds: Optional[int] = None, seed: int = 0,
                regimes: Optional[Sequence[str]] = None,
                steady_reps: int = 2, device=None, profile: bool = True):
    """Capture every ported regime (or the named subset, where an unported
    one raises) -> list of PerfReports, in REGIME_NAMES order."""
    reports = []
    for name in (PORTED_REGIMES if regimes is None else regimes):
        report, _ = capture_regime(
            name, n_nodes=n_nodes, trials=trials, max_rounds=max_rounds,
            seed=seed, steady_reps=steady_reps,
            device=device, profile=profile)
        reports.append(report)
    return reports
