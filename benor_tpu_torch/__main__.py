"""CLI driver (port of benor_tpu/__main__.py): the reference's `yarn start`
demo plus the science harness, on the card.

`python -m benor_tpu_torch` reproduces src/start.ts:6-43: launch 10 nodes
with 4 faulty, all-1 inputs, run consensus, print each node's final state.

Subcommands (the JAX package's arguments, defaults, printed lines and
exit codes):
  demo    [--backend tpu|express|native] [-n N] [-f F] the start.ts demo
  sweep   --n N --f-values 0,100,...                  rounds-vs-f curve;
          [--batched --journal J --resume --pipeline] the batched engine
                                                      and its journal
  coins   --n N --f F [--eps ...]                     private vs common coin
  trace   --n N --f F --out trace.json                flight-recorder round
                                                      history as a Chrome-
                                                      trace/Perfetto file
  preset  NAME                                        a BASELINE.json config
  results [--out DIR] [--n N] [--trials T]            RESULTS/ (the studies)
  audit   --n N --f F [--witness-trials 0,1]          run one witnessed
          [--witness-nodes k] [--audit-out b.json]    config and check the
                                                      Ben-Or invariants;
                                                      exit 2 on violations
  atlas   [--searches omission,partition,quorum]      cliff search ->
          [--axis SPEC] [--heatmap A,B]               atlas manifest, gated
                                                      against
                                                      ATLAS_BASELINE.json;
                                                      exit 2 on drift
  replay  PATH                                        re-run an atlas_repro
                                                      document; exit 2 on a
                                                      mismatch
  profile [--regimes traced,...] [--profile-out m.json] the regimes' stages,
          [--kernels [--telemetry-out t.jsonl]]       footprint and device
          [--baseline B --update-baseline]            profile (perfscope),
          [--trace-dir DIR]                           or the round kernels'
                                                      stage counters
                                                      (kernelscope), gated
                                                      against PERF_ /
                                                      KERNEL_BASELINE.json;
                                                      exit 2 on regression
  serve   [--host H --port P] [--max-batch-jobs B]    the request plane:
          [--trace-out t.json]                        HTTP + SSE job API
                                                      over the warm batch
                                                      executor pool
  load    [--clients C] [--url URL] [--job JSON]      concurrent SSE clients
          [--profile-out m.json] [--baseline B]       -> serve manifest,
                                                      gated against
                                                      SERVE_BASELINE.json;
                                                      exit 2 on regression
  watch   PATH [--no-follow] [--timeout S]            tail a JSON-lines
                                                      progress file
                                                      (heartbeats, journal,
                                                      kernel telemetry,
                                                      atlas records)

Observability: ``--record`` (sweep) fills the flight recorder;
``--metrics-out PATH`` (sweep, coins, trace, audit, profile) writes the
metrics registry on exit (JSON-lines, or the Prometheus textfile format
with a .prom extension); sweep ``--batched --trace-out t.json`` writes the
buckets' span trees as a Chrome-trace/Perfetto file and ``--batched
--manifest-out m.json`` the sweep manifest (sweepscope); ``--batched
--heartbeat-rounds h --heartbeat-out PATH`` appends one progress beat a
bucket for ``watch``.

Every subcommand runs on the CUDA device unless ``--device cpu`` is
given; with no CUDA device and no ``--device cpu`` it fails (exit 1)
instead of moving to the CPU.  ``demo --backend express|native`` runs the
event-loop oracles and ``watch`` tails a file: host programs that need no
device.  Not ported: ``lint`` (ROADMAP Queue A item 16), ``scale`` and
``profile --regimes sharded`` (item 15): each raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .config import unported

#: Subcommands of the JAX CLI that wait for a later Queue A item.
UNPORTED_COMMANDS = {
    "lint": ("the `lint` subcommand (benorlint)", "16"),
    "scale": ("the `scale` subcommand (mesh scaling ladders)", "15"),
}


def _refuse_unported(args) -> None:
    """Raise for an unported regime, before any device is touched."""
    if args.cmd == "profile" and args.regimes and not args.kernels:
        from .perfscope.regimes import UNPORTED_REGIMES
        for name in args.regimes.split(","):
            if name in UNPORTED_REGIMES:
                unported(f"profile --regimes {name} (a mesh run)",
                         UNPORTED_REGIMES[name])


def _demo(args) -> int:
    from .api import get_nodes_state, launch_network, start_consensus
    n, f = args.n, args.f
    # start.ts:25-29 — the reference refuses F > N/2 in the demo driver
    if f > n / 2:
        print("Too many faulty nodes", file=sys.stderr)
        return 1
    initial = [1] * n                      # start.ts:9-20: all-1 inputs
    faulty = [True] * f + [False] * (n - f)
    net = launch_network(n, f, initial, faulty, backend=args.backend,
                         max_rounds=args.max_rounds, seed=args.seed,
                         device=args.device)
    start_consensus(net)
    for i, st in enumerate(get_nodes_state(net)):
        print(f"node {i}: {st}")
    return 0


def _add_device_arg(sub) -> None:
    """ONE definition of --device for every subcommand that runs."""
    sub.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where to run: the CUDA device (default; no "
                          "fallback when there is none) or the CPU, "
                          "which runs the kernels' plain versions")


def _add_pallas_arg(sub) -> None:
    """ONE definition of the --pallas option for every subparser that
    runs the compute path."""
    sub.add_argument("--pallas", choices=("auto", "on", "off"),
                     default="auto",
                     help="the flagship kernels (auto: on for the CUDA "
                          "device, off on the CPU)")


def _add_obs_args(sub, record: bool = True) -> None:
    """ONE definition of the observability options (flight recorder and
    metrics export) for every compute subcommand."""
    if record:
        sub.add_argument("--record", action="store_true",
                         help="fill the flight recorder (SimConfig."
                              "record): per-round decided/killed/value-"
                              "histogram/coin/margin telemetry")
    sub.add_argument("--metrics-out", metavar="PATH",
                     help="write the metrics registry (utils/metrics.py: "
                          "timers and counters) as JSON-lines on exit; "
                          "a .prom extension switches to the Prometheus "
                          "textfile format")


def _export_metrics(path) -> None:
    if not path:
        return
    from .utils import metrics
    if str(path).endswith(".prom"):
        n = metrics.export_prometheus(path)
    else:
        n = metrics.export_jsonl(path)
    print(f"wrote {n} metrics records to {path}", file=sys.stderr,
          flush=True)


def _pallas_flags(choice: str, device) -> dict:
    """--pallas plumbing: 'auto' arms the flagship kernels exactly when
    results.py's studies do (on the CUDA device, not on the CPU); 'on'
    forces the flags (the CPU runs their plain versions); 'off' clears
    them.  Configs the kernels do not serve ignore the flags."""
    from .results import FLAGSHIP_FLAGS, _flagship_flags
    if choice == "on":
        return dict(FLAGSHIP_FLAGS)
    if choice == "off":
        return {}
    return _flagship_flags(device)


def _sweep(args) -> int:
    from .config import SimConfig
    from .sweep import rounds_vs_f, run_point, save_points
    f_values = [int(x) for x in args.f_values.split(",")]
    flags = _pallas_flags(args.pallas, args.device)
    cfg = SimConfig(n_nodes=args.n, n_faulty=0, trials=args.trials,
                    max_rounds=args.max_rounds, delivery="quorum",
                    scheduler=args.scheduler, coin_mode=args.coin,
                    fault_model=args.fault_model, seed=args.seed,
                    record=args.record,
                    heartbeat_rounds=args.heartbeat_rounds, **flags)
    if args.heartbeat_rounds and not args.batched:
        # the per-point path runs each point as one loop: there is no
        # boundary to beat at, and a silent no-op would fake progress
        print("warning: --heartbeat-rounds only publishes on the "
              "batched engine (per bucket); add --batched, or use "
              "`trace`/poll_rounds for per-round liveness",
              file=sys.stderr)
    if not args.batched and (args.journal or args.resume
                             or args.trace_out or args.manifest_out
                             or args.pipeline):
        # sweepscope instruments the BUCKET lifecycle; the per-point path
        # has no buckets — a silent no-op would fake durability or tracing
        print("warning: --journal/--resume/--trace-out/--manifest-out/"
              "--pipeline instrument the batched engine's buckets; "
              "add --batched", file=sys.stderr)
    if args.resume and not args.journal:
        print("sweep: --resume requires --journal (the journal is the "
              "resume substrate)", file=sys.stderr)
        return 1
    if args.trace_out and args.batched:
        from .utils.metrics import SPANS
        SPANS.enable()
    journal_kw = dict(journal_path=args.journal, resume=args.resume,
                      pipeline=args.pipeline, device=args.device,
                      heartbeat_path=args.heartbeat_out)
    mode = "balanced/no-crash" if args.balanced else "iid/crash"
    # the banner reports the compute path taken, per f value: the kernel
    # predicates gate on the quorum N - f
    from .ops.tally import pallas_round_active, pallas_stream_active

    def _engaged(c):
        return pallas_round_active(c) or pallas_stream_active(c)

    eng = [_engaged(cfg.replace(n_faulty=int(f))) for f in f_values]
    pallas_note = (", pallas" if eng and all(eng)
                   else ", pallas (where eligible)" if any(eng) else "")
    print(f"rounds-vs-f sweep: N={args.n}, trials={args.trials}, "
          f"scheduler={args.scheduler}, coin={args.coin}, "
          f"faults={args.fault_model}, inputs={mode}"
          f"{pallas_note}")
    t0 = time.perf_counter()
    if args.balanced:
        # the science regime: balanced inputs, F purely a protocol
        # parameter; under 'byzantine'/'equivocate' the F lanes are LIVE
        # adversaries, so they are marked (not crashed) rather than zeroed
        from .state import FaultSpec
        from .sweep import balanced_inputs, run_curve_batched
        bal = balanced_inputs(args.trials, args.n)

        def faults_for(c):
            if c.fault_model in ("byzantine", "equivocate"):
                return FaultSpec.first_f(c)
            return FaultSpec.none(args.trials, args.n)

        if args.batched:
            cb = run_curve_batched(cfg, f_values, initial_values=bal,
                                   faults_for=faults_for, verbose=True,
                                   **journal_kw)
            points = cb.points
        else:
            points = []
            for f in f_values:
                cfg_f = cfg.replace(n_faulty=int(f))
                points.append(run_point(cfg_f, initial_values=bal,
                                        faults=faults_for(cfg_f),
                                        device=args.device))
        for pt in points:
            print(f"  f={pt.n_faulty}: mean_k={pt.mean_k:.2f} "
                  f"decided={pt.decided_frac:.3f} "
                  f"disagree={pt.disagree_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    elif args.batched:
        from .sweep import run_curve_batched
        cb = run_curve_batched(cfg, f_values, verbose=True, **journal_kw)
        points = cb.points
        for pt in points:
            print(f"  f={pt.n_faulty}: mean_k={pt.mean_k:.2f} "
                  f"decided={pt.decided_frac:.3f} "
                  f"{pt.trials_per_sec:.1f} trials/s", flush=True)
    else:
        points = rounds_vs_f(cfg, f_values, device=args.device)
    from .utils.metrics import REGISTRY
    REGISTRY.timer("cli.sweep").record(time.perf_counter() - t0)
    if args.batched and args.manifest_out:
        from .sweepscope import build_sweep_manifest, save_sweep_manifest
        try:
            save_sweep_manifest(args.manifest_out,
                                build_sweep_manifest(cb, cfg,
                                                     device=args.device))
            print(f"wrote sweep manifest to {args.manifest_out}",
                  file=sys.stderr)
        except ValueError as e:
            # a resumed curve's stage clocks price the original run —
            # build_sweep_manifest refuses; say so instead of writing a lie
            print(f"sweep: no manifest written: {e}", file=sys.stderr)
    if args.batched and args.trace_out:
        from .utils.metrics import export_chrome_trace
        n_ev = export_chrome_trace(args.trace_out, spans=True)
        print(f"wrote {n_ev} trace events to {args.trace_out} "
              f"(open in ui.perfetto.dev)", file=sys.stderr)
    if args.record:
        from .utils.metrics import round_history_summary
        for pt in points:
            s = round_history_summary(pt.round_history)
            print(f"  f={pt.n_faulty}: quiescence_round="
                  f"{s['rounds_to_quiescence']} "
                  f"decide_velocity={s['decide_velocity']}", flush=True)
    if args.out:
        save_points(args.out, points)
        print(f"wrote {args.out}")
    _export_metrics(args.metrics_out)
    return 0


def _trace(args) -> int:
    """Run ONE recorded config and export a Chrome-trace/Perfetto file:
    every protocol round as a trace slice (its telemetry row in args)
    beside the registry's host-side timer spans."""
    from .config import SimConfig
    from .state import FaultSpec
    from .sweep import balanced_inputs, run_point
    from .utils import metrics
    from .utils.tracing import timed

    cfg = SimConfig(n_nodes=args.n, n_faulty=args.f, trials=args.trials,
                    max_rounds=args.max_rounds, delivery="quorum",
                    scheduler=args.scheduler, coin_mode=args.coin,
                    fault_model=args.fault_model, seed=args.seed,
                    record=True, **_pallas_flags(args.pallas, args.device))
    with timed("trace.run"):
        if args.balanced:
            faults = (FaultSpec.first_f(cfg)
                      if cfg.fault_model in ("byzantine", "equivocate")
                      else FaultSpec.none(args.trials, args.n))
            pt = run_point(cfg, initial_values=balanced_inputs(
                args.trials, args.n), faults=faults, device=args.device)
        else:
            pt = run_point(cfg, device=args.device)
    summ = metrics.round_history_summary(pt.round_history)
    n_ev = metrics.export_chrome_trace(
        args.out, round_history=pt.round_history,
        rounds_label=f"benor N={args.n} f={args.f}")
    print(f"rounds={pt.rounds_executed} decided={pt.decided_frac:.3f} "
          f"mean_k={pt.mean_k:.2f} "
          f"quiescence_round={summ['rounds_to_quiescence']}")
    print(f"wrote {n_ev} trace events to {args.out} "
          f"(open in https://ui.perfetto.dev or chrome://tracing)")
    _export_metrics(args.metrics_out)
    return 0


def _audit(args) -> int:
    """Run ONE witnessed config and machine-check the Ben-Or invariants:
    prints the audit verdict (pinpointed violations with trial/round/node
    ids and tallies), optionally dumps the JSON witness bundle, and feeds
    the audit.* counters of the metrics registry.  Exit code 0 = clean,
    2 = violations found (so CI can gate on it)."""
    from .audit import audit_point, default_witness_overrides, save_bundle
    from .config import SimConfig
    from .state import FaultSpec
    from .sweep import balanced_inputs

    dflt = default_witness_overrides(args.trials, args.n)
    wt = (tuple(int(x) for x in args.witness_trials.split(","))
          if args.witness_trials else dflt["witness_trials"])
    wk = args.witness_nodes or dflt["witness_nodes"]
    cfg = SimConfig(n_nodes=args.n, n_faulty=args.f, trials=args.trials,
                    max_rounds=args.max_rounds, delivery="quorum",
                    scheduler=args.scheduler, coin_mode=args.coin,
                    fault_model=args.fault_model, seed=args.seed,
                    witness_trials=wt, witness_nodes=wk,
                    **_pallas_flags(args.pallas, args.device))
    initial = faults = unanimous = None
    if args.balanced:
        initial = balanced_inputs(args.trials, args.n)
        if cfg.fault_model not in ("byzantine", "equivocate"):
            faults = FaultSpec.none(args.trials, args.n)
    if args.unanimous is not None:
        initial = np.full((args.trials, args.n), args.unanimous, np.int8)
        unanimous = args.unanimous
    report, bundle = audit_point(cfg, initial_values=initial,
                                 faults=faults, unanimous=unanimous,
                                 label=f"cli N={args.n} f={args.f}",
                                 device=args.device)
    print(f"watched trials={[int(t) for t in bundle.trial_ids]} "
          f"nodes={[int(i) for i in bundle.node_ids]}")
    print(report.summary())
    for v in report.violations[:args.max_violations]:
        print(f"  [{v.invariant}] {v.message}")
    if len(report.violations) > args.max_violations:
        print(f"  ... {len(report.violations) - args.max_violations} more "
              f"(see --audit-out)")
    if args.audit_out:
        save_bundle(args.audit_out, bundle, report)
        print(f"wrote witness bundle to {args.audit_out}")
    _export_metrics(args.metrics_out)
    return 0 if report.ok else 2


def _coins(args) -> int:
    from .config import SimConfig
    from .state import FaultSpec
    from .sweep import balanced_inputs, coin_comparison, run_point
    cfg = SimConfig(n_nodes=args.n, n_faulty=args.f, trials=args.trials,
                    max_rounds=args.max_rounds, seed=args.seed,
                    **_pallas_flags(args.pallas, args.device))
    res = coin_comparison(cfg, device=args.device)
    for mode, pts in res.items():
        p = pts[0]
        print(f"{mode}: decided={p.decided_frac:.3f} mean_k={p.mean_k:.2f}")
    for eps in (args.eps or []):
        wcfg = cfg.replace(coin_mode="weak_common", coin_eps=eps,
                           scheduler="adversarial", delivery="quorum")
        p = run_point(wcfg, initial_values=balanced_inputs(args.trials,
                                                           args.n),
                      faults=FaultSpec.none(args.trials, args.n),
                      device=args.device)
        print(f"weak_common(eps={eps}): decided={p.decided_frac:.3f} "
              f"mean_k={p.mean_k:.2f}")
    _export_metrics(args.metrics_out)
    return 0


#: (n_nodes, trials) defaults of `results` (the JAX package's
#: utils/backend.py FULL_SCALE and SMOKE_SCALE): the N = 1M x 32 study set
#: on the card, the same studies at smoke scale on the CPU.
FULL_SCALE = (1_000_000, 32)
SMOKE_SCALE = (50_000, 8)


def _results(args) -> int:
    from .results import generate
    n, trials = args.n, args.trials
    if n is None or trials is None:
        on_cpu = args.device == "cpu"
        dn, dt = SMOKE_SCALE if on_cpu else FULL_SCALE
        n = dn if n is None else n
        trials = dt if trials is None else trials
        if on_cpu:
            print(f"results: CPU backend — defaulting to N={dn:,}, "
                  f"trials={dt} (pass --n/--trials to override)",
                  flush=True)
    generate(out_dir=args.out, n_large=n, trials_large=trials,
             seed=args.seed, presets=not args.no_presets,
             device=args.device)
    return 0


def _atlas(args) -> int:
    """The phase-boundary observatory (atlas/): adaptive cliff search over
    the scenario grid -> atlas manifest + cliff-drift gate vs the
    committed ATLAS_BASELINE.json.  Exit 2 on drift findings; an
    incomparable baseline (platform/scale mismatch) is a printed note,
    not a failure.  ``--metrics-out`` is accepted and writes nothing, as
    in the JAX package."""
    from .atlas import gate as agate
    from .atlas import manifest as amanifest
    from .atlas import render_heatmap
    from .atlas import search as asearch

    verbose = args.format == "text"
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    if args.heatmap:
        from .config import SimConfig
        spec_a, spec_b = args.heatmap.split(",", 1)
        cfg = SimConfig(n_nodes=args.n, n_faulty=args.f,
                        trials=args.trials, max_rounds=args.max_rounds,
                        delivery="all", path="histogram",
                        seed=args.seed)
        doc = asearch.heatmap_slice(cfg, spec_a, spec_b,
                                    na=args.coarse, nb=args.coarse,
                                    journal_path=args.journal,
                                    verbose=verbose, device=args.device)
        asearch.export_heatmap(doc, json_path=args.profile_out,
                               trace_path=args.trace_out)
        if args.format == "json":
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print(render_heatmap(doc))
            print(f"  {len(doc['rows'])} probes in {doc['n_buckets']} "
                  f"bucket(s), {doc['compile_count']} compile(s)")
        return 0

    if args.axis:
        from .config import SimConfig
        cfg = SimConfig(n_nodes=args.n, n_faulty=args.f,
                        trials=args.trials, max_rounds=args.max_rounds,
                        delivery="all", path="histogram",
                        seed=args.seed)
        docs = []
        for i, spec in enumerate(args.axis):
            res = asearch.find_cliffs(
                cfg, spec, coarse=args.coarse,
                journal_path=args.journal,
                resume=args.resume or i > 0,
                forensics=not args.no_forensics,
                out_dir=args.out_dir, verbose=verbose, device=args.device)
            d = res.to_dict()
            d["name"] = f"axis{i}"
            docs.append(d)
        manifest = amanifest.build_manifest(docs, scale=args.scale,
                                            device=args.device)
    else:
        searches = tuple(s for s in args.searches.split(",") if s)
        manifest = amanifest.capture_atlas(
            searches=searches, scale=args.scale,
            forensics=not args.no_forensics,
            journal_path=args.journal, resume=args.resume,
            out_dir=args.out_dir, verbose=verbose, device=args.device)

    baseline_path = args.baseline or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "ATLAS_BASELINE.json")
    if args.update_baseline:
        amanifest.save_manifest(baseline_path, manifest)
        print(f"baseline updated: {baseline_path} "
              f"({manifest['cliff_count']} cliffs, "
              f"{manifest['probe_count']} probes)")
        return 0
    if args.profile_out:
        amanifest.save_manifest(args.profile_out, manifest)
    if args.format == "json":
        print(json.dumps(manifest, indent=1, sort_keys=True))
    else:
        for s in manifest["searches"]:
            print(f"[{s['name']}] {s['spec']}: {s['probe_count']} "
                  f"probes / {len(s['generations'])} generations / "
                  f"{s['compile_count']} compiles")
            for c in s["cliffs"]:
                extra = ""
                if c.get("safety"):
                    extra += (" audit_ok" if c["safety"]["audit_ok"]
                              else f" VIOLATIONS="
                                   f"{c['safety']['n_violations']}")
                if c.get("repro_reproduced") is not None:
                    extra += (" repro_ok" if c["repro_reproduced"]
                              else " REPRO-STALE")
                print(f"  cliff {c['axis']}={c['point']:g} bracket "
                      f"[{c['lo']:g}, {c['hi']:g}] "
                      f"{c['lo_verdict']}->{c['hi_verdict']}{extra}")
    if os.path.exists(baseline_path):
        try:
            findings = agate.compare_atlas(
                manifest, amanifest.load_manifest(baseline_path))
        except (agate.IncomparableAtlas, ValueError) as e:
            print(f"atlas: baseline not comparable ({e}) — skipping "
                  f"the drift gate", file=sys.stderr)
            return 0
        for f in findings:
            print(f"REGRESSION: [{f.metric}] {f.message}")
        if findings:
            return 2
        print(f"atlas: in-band vs {os.path.basename(baseline_path)}")
    return 0


def _replay(args) -> int:
    """Re-execute a ``kind: atlas_repro`` document and pin it bit for bit:
    exit 0 reproduced, 2 verdict/digest mismatch, 1 unreadable input."""
    from .atlas import repro as arepro

    try:
        doc = arepro.load_repro(args.path)
    except (OSError, ValueError) as e:
        print(f"replay: unreadable repro: {e}", file=sys.stderr)
        return 1
    res = arepro.replay_repro(doc, args.device)
    if args.format == "json":
        print(json.dumps(res, indent=1, sort_keys=True))
    else:
        v, e = res["verdict"], res["expected"]
        print(f"replay {os.path.basename(args.path)} "
              f"[{doc.get('label') or 'unlabeled'}]: "
              f"digest {'ok' if res['digest_ok'] else 'MISMATCH'}, "
              f"verdict {v['verdict']} (recorded {e.get('verdict')}) "
              f"rounds={v['rounds_executed']} "
              f"decided={v['decided_frac']:g} -> "
              f"{'REPRODUCED' if res['ok'] else 'NOT REPRODUCED'}")
    return 0 if res["ok"] else 2


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: The committed baselines ``profile`` and ``load`` read by default and
#: never write: they are the JAX package's captures.
COMMITTED_BASELINES = ("PERF_BASELINE.json", "KERNEL_BASELINE.json",
                       "SWEEP_BASELINE.json", "SERVE_BASELINE.json")


def _baseline_target(args):
    """``--update-baseline``'s file: an explicit ``--baseline PATH`` that
    is none of the committed baselines, or None (refused, said why)."""
    committed = {os.path.realpath(os.path.join(_repo_root(), name))
                 for name in COMMITTED_BASELINES}
    if not args.baseline or os.path.realpath(args.baseline) in committed:
        where = (f"onto {args.baseline}" if args.baseline
                 else "without --baseline PATH")
        print(f"{args.cmd}: refusing --update-baseline {where}: the "
              f"committed {', '.join(COMMITTED_BASELINES)} are the JAX "
              f"package's captures and are never written; name another "
              f"file with --baseline", file=sys.stderr)
        return None
    return args.baseline


def _profile_kernels(args) -> int:
    """kernelscope capture (``profile --kernels``): arm the stage counters
    on both packed dispatches (the fused kernel, the two-kernel pair),
    report them per stage and per tile with the traffic model's predicted
    bytes (and, on the card, the kernels' device time against their
    bound), emit the ``kind: kernel_manifest`` document and gate it
    against KERNEL_BASELINE.json: exit 2 on a regression, 0 otherwise (an
    incomparable baseline is reported and skipped)."""
    from .kernelscope import (IncomparableKernels, capture_kernels,
                              compare_kernels, load_kernel_manifest,
                              save_kernel_manifest)

    target = None
    if args.update_baseline:
        target = _baseline_target(args)
        if target is None:
            return 1
    manifest = capture_kernels(n_nodes=args.n, trials=args.trials,
                               max_rounds=args.max_rounds, seed=args.seed,
                               telemetry_path=args.telemetry_out,
                               device=args.device)
    if args.format == "json":
        print(json.dumps(manifest, indent=1))
    else:
        sc = manifest["scale"]
        mode = "plain versions" if manifest["interpret"] else "kernels"
        print(f"kernelscope: {manifest['platform']} "
              f"({manifest['device_kind']}, {mode}), scale "
              f"N={sc['n_nodes']} T={sc['trials']} "
              f"R<={sc['max_rounds']} seed={sc['seed']}")
        for name, rep in manifest["kernels"].items():
            pred = rep["predicted_bytes_per_round"]
            print(f"  {name} [{rep['dispatch']}/{rep['counts_mode']}]: "
                  f"rounds={rep['rounds_executed']} "
                  f"pad_waste={rep['pad_waste_frac']} "
                  f"hops/round={rep['plane_hops_per_round']} "
                  f"predicted={pred['total']}B/round "
                  f"bit_equal={rep['bit_equal_off_on']}")
            for stage, blk in rep["stages"].items():
                print(f"    {stage}: {blk['counters']}")
            dv = rep.get("device")
            if dv:
                # the bound is None on a card off the peak table
                print(f"    device: {dv['device_ms_per_round']:.4f} ms a "
                      f"round {dv['launches']}, predicted "
                      f"{dv['predicted_kernel_bytes_per_round']} B and "
                      f"{dv['predicted_ops_per_round']:.4g} ops a round, "
                      f"bound {dv['bound_ms_per_round']} ms "
                      f"({dv['bound_by']}), share {dv['bound_share']}")
        fvx = manifest.get("fused_vs_xla")
        if fvx:
            print(f"  fused_vs_xla: stage shares "
                  f"{fvx['stage_attribution']}, "
                  f"bit_equal={fvx['bit_equal']}")
    if args.profile_out:
        save_kernel_manifest(args.profile_out, manifest)
        print(f"wrote kernel manifest to {args.profile_out}",
              file=sys.stderr)
    _export_metrics(args.metrics_out)

    if target is not None:
        save_kernel_manifest(target, manifest)
        print(f"re-baselined {target}", file=sys.stderr)
        return 0
    baseline_path = args.baseline or os.path.join(_repo_root(),
                                                  "KERNEL_BASELINE.json")
    if not os.path.exists(baseline_path):
        print(f"no baseline at {baseline_path} — capture-only run",
              file=sys.stderr)
        return 0
    try:
        findings = compare_kernels(manifest,
                                   load_kernel_manifest(baseline_path))
    except (IncomparableKernels, ValueError) as e:
        print(f"baseline {baseline_path} not comparable: {e}",
              file=sys.stderr)
        return 0
    for f in findings:
        print(f"REGRESSION [{f.kind}]: {f.message}", file=sys.stderr)
    if findings:
        return 2
    print(f"kernel gate: in-band vs {baseline_path}", file=sys.stderr)
    return 0


def _profile(args) -> int:
    """The performance observatory (perfscope): each ported regime's
    stages (the kernel library's build and load, the first and steady
    executions), memory footprint and, on the card, one profiler pass
    (device busy share, kernel launches, top device entries), and the
    packed loop against the unfused one.  Emits the manifest
    (``--profile-out`` / ``--format json``), optionally inside a
    ``torch.profiler`` trace (``--trace-dir``, with the metrics
    registry's tracks beside it), and gates it against a baseline: exit 2
    on an out-of-band metric, 0 otherwise."""
    if args.kernels:
        return _profile_kernels(args)
    from .perfscope import (IncomparableManifests, build_manifest,
                            capture_all, compare_manifests, load_manifest,
                            missing_regimes, save_manifest)
    from .perfscope.regimes import (PORTED_REGIMES, REGIME_NAMES,
                                    UNPORTED_REGIMES, capture_fused_vs_xla,
                                    default_profile_scale)

    scale = default_profile_scale(args.device)
    for k, v in (("n_nodes", args.n), ("trials", args.trials),
                 ("max_rounds", args.max_rounds)):
        if v is not None:
            scale[k] = v
    scale["seed"] = args.seed
    regimes = args.regimes.split(",") if args.regimes else None
    if regimes:
        unknown = sorted(set(regimes) - set(REGIME_NAMES))
        if unknown:
            print(f"unknown regimes {unknown}; choose from "
                  f"{list(REGIME_NAMES)}", file=sys.stderr)
            return 1
    target = None
    if args.update_baseline:
        target = _baseline_target(args)
        if target is None:
            return 1

    import contextlib
    trace_cm = contextlib.nullcontext()
    if args.trace_dir:
        from .utils.tracing import profile_trace
        trace_cm = profile_trace(args.trace_dir)
    # under --trace-dir the one profiler records the whole capture; the
    # per-regime passes (a profiler inside a profiler) are left out
    kw = dict(steady_reps=args.steady_reps, device=args.device,
              profile=not args.trace_dir, **scale)
    with trace_cm as trace_path:
        reports = capture_all(regimes=regimes, **kw)
        fvx = None
        if regimes is None:
            # the paired measurement rides every full capture; a subset
            # records an explicit null
            fvx = capture_fused_vs_xla(**kw)
    manifest = build_manifest(reports, scale, fused_vs_xla=fvx,
                              device=args.device)
    if args.trace_dir:
        from .utils import metrics
        counters = os.path.join(args.trace_dir,
                                "perfscope_counters.trace.json")
        n_ev = metrics.export_chrome_trace(counters)
        print(f"torch.profiler trace in {trace_path} "
              f"(+{n_ev} counter events in {counters})", file=sys.stderr)

    if args.format == "json":
        print(json.dumps(manifest, indent=1))
    else:
        print(f"perfscope: {manifest['platform']} "
              f"({manifest['device_kind']}), scale "
              f"N={scale['n_nodes']} T={scale['trials']} "
              f"R<={scale['max_rounds']} seed={scale['seed']}")
        for r in reports:
            peak = ("n/a" if r.peak_bytes is None
                    else f"{r.peak_bytes / 2 ** 20:.1f} MiB")
            prof = ""
            if r.device_busy_share is not None:
                prof = (f" | busy {r.device_busy_share:.4f} "
                        f"launches {r.kernel_launches} top "
                        f"{[e[0] for e in r.top_device[:3]]}")
            print(f"  {r.regime}: build {r.compile_s * 1e3:.0f}ms "
                  f"({r.backend_compiles} library event(s)) "
                  f"first {r.first_execute_s * 1e3:.0f}ms "
                  f"steady {r.steady_execute_s * 1e3:.1f}ms | "
                  f"rounds={r.rounds_executed} peak={peak}{prof}")
        for name, item in UNPORTED_REGIMES.items():
            print(f"  {name}: not ported (ROADMAP Queue A item {item})")
        if fvx:
            print(f"  fused_vs_xla: bit_equal={fvx['bit_equal']} "
                  f"speedup={fvx['speedup']} ({fvx['counts_mode']}, "
                  f"one_pass={fvx['one_pass']}, against "
                  f"{fvx['baseline_path']}"
                  f"{', plain versions' if fvx['interpret_mode'] else ''})"
                  f" packed_traffic_ratio={fvx['packed_traffic_ratio']}")
    if args.profile_out:
        save_manifest(args.profile_out, manifest)
        print(f"wrote perf manifest to {args.profile_out}",
              file=sys.stderr)
    _export_metrics(args.metrics_out)

    missing = missing_regimes(manifest)
    if target is not None:
        if missing:
            # a partial baseline would make every later gate pass
            # vacuously: compare_manifests only walks baseline regimes
            print(f"refusing to write a partial baseline (missing "
                  f"{missing}) — a baseline must cover all of "
                  f"{list(PORTED_REGIMES)}", file=sys.stderr)
            return 1
        save_manifest(target, manifest)
        print(f"re-baselined {target}", file=sys.stderr)
        return 0
    baseline_path = args.baseline or os.path.join(_repo_root(),
                                                  "PERF_BASELINE.json")
    if not os.path.exists(baseline_path):
        print(f"no baseline at {baseline_path} — capture-only run",
              file=sys.stderr)
        return 0
    if regimes and missing:
        print(f"partial capture ({sorted(set(regimes))}) — baseline gate "
              f"skipped (a full manifest covers {list(PORTED_REGIMES)})",
              file=sys.stderr)
        return 0
    try:
        regressions = compare_manifests(manifest,
                                        load_manifest(baseline_path),
                                        timing_band=args.timing_band)
    except (IncomparableManifests, ValueError) as e:
        print(f"baseline {baseline_path} not comparable: {e}",
              file=sys.stderr)
        return 0
    for reg in regressions:
        print(f"REGRESSION: {reg.message}", file=sys.stderr)
    if regressions:
        return 2
    print(f"perf gate: in-band vs {baseline_path}", file=sys.stderr)
    return 0


def _serve(args) -> int:
    """The request plane (serve/server.py): accept concurrent simulate /
    sweep / trajectory / audit jobs over HTTP, coalesce them into batches
    on the warm executor pool, stream round-history and witness rows back
    as server-sent events.  Runs until interrupted."""
    from .serve import run_server
    return run_server(host=args.host, port=args.port,
                      max_batch_jobs=args.max_batch_jobs,
                      trace_out=args.trace_out, device=args.device)


def _load(args) -> int:
    """Load-test the request plane (serve/loadgen.py): drive --clients
    concurrent SSE clients (against --url, or an in-process server on
    --device when omitted), print the serve manifest (p50/p99 latency,
    throughput, jobs a launch) and gate it against the committed
    SERVE_BASELINE.json (serve/gate.py): exit 2 on a regression, 0
    otherwise; an incomparable baseline (another platform) is reported.
    ``--update-baseline`` writes only to an explicit ``--baseline PATH``
    that is none of the committed baselines."""
    from .serve import IncomparableServe, compare_serve, run_load

    target = None
    if args.update_baseline:
        target = _baseline_target(args)
        if target is None:
            return 1
    job = None
    if args.job:
        job = json.loads(args.job)
    if args.trace_out:
        from .utils.metrics import SPANS
        SPANS.enable()
    manifest = run_load(url=args.url, clients=args.clients, job=job,
                        timeout=args.timeout, ramp_s=args.ramp,
                        max_batch_jobs=args.max_batch_jobs,
                        device=args.device)
    if args.trace_out:
        from .utils.metrics import export_chrome_trace
        n = export_chrome_trace(args.trace_out, spans=True)
        print(f"wrote {n} trace events to {args.trace_out} "
              f"(open in ui.perfetto.dev)", file=sys.stderr)
    if args.format == "json":
        print(json.dumps(manifest, indent=1))
    else:
        lat = manifest["latency_ms"]
        attr = manifest["attribution"]
        print(f"benor-serve load: {manifest['platform']} "
              f"({manifest['device_kind']}), {manifest['clients']} "
              f"concurrent clients")
        print(f"  jobs {manifest['jobs_completed']}"
              f"/{manifest['jobs_submitted']} "
              f"(errors {manifest['errors']}) in "
              f"{manifest['duration_s']:.2f}s = "
              f"{manifest['throughput_jobs_per_sec']:.1f} jobs/s")
        print(f"  latency p50={lat['p50']:.0f}ms p99={lat['p99']:.0f}ms; "
              f"coalescing {manifest['jobs_per_launch']:.1f} "
              f"jobs/launch over {manifest['launches']} launches")
        stages = manifest["stages"]
        print("  stages p99 (ms): "
              + " ".join(f"{s}={stages[s]['p99']:.0f}"
                         for s in ("queue_wait", "batch_assemble",
                                   "launch", "stream_out")))
        print(f"  attribution: {attr['stage_mean_sum_ms']:.0f}ms of "
              f"{attr['client_mean_ms']:.0f}ms client mean attributed "
              f"(coverage {attr['coverage']:.2f}, "
              f"{'ok' if attr['ok'] else 'INCOMPLETE'})")
    if args.profile_out:
        with open(args.profile_out, "w") as fh:
            json.dump(manifest, fh, indent=1)
        print(f"wrote serve manifest to {args.profile_out}",
              file=sys.stderr)
    _export_metrics(args.metrics_out)

    if target is not None:
        with open(target, "w") as fh:
            json.dump(manifest, fh, indent=1)
        print(f"re-baselined {target}", file=sys.stderr)
        return 0
    baseline_path = args.baseline or os.path.join(_repo_root(),
                                                  "SERVE_BASELINE.json")
    if not os.path.exists(baseline_path):
        print(f"no baseline at {baseline_path} — capture-only run "
              f"(--update-baseline to create one)", file=sys.stderr)
        return 0
    try:
        with open(baseline_path) as fh:
            base = json.load(fh)
        findings = compare_serve(manifest, base,
                                 timing_band=args.timing_band)
    except (IncomparableServe, ValueError) as e:
        print(f"baseline {baseline_path} not comparable: {e}",
              file=sys.stderr)
        return 0
    for f in findings:
        print(f"REGRESSION: {f.message}", file=sys.stderr)
    if findings:
        return 2
    print(f"serve gate: in-band vs {baseline_path}", file=sys.stderr)
    return 0


def _format_heartbeat(rec) -> str:
    bits = [f"[{rec.get('label', '?')}]"]
    if rec.get("round") is not None:
        bits.append(f"round={rec['round']}/{rec.get('max_rounds')}")
    if rec.get("points_done") is not None:
        bits.append(f"points={rec['points_done']}"
                    f"/{rec.get('points_total')}")
    if rec.get("rounds_per_sec") is not None:
        bits.append(f"{rec['rounds_per_sec']:.3g} rounds/s")
    if rec.get("decided_frac") is not None:
        bits.append(f"decided={rec['decided_frac']:.3f}")
    if rec.get("eta_s") is not None:
        bits.append(f"eta={rec['eta_s']:.1f}s")
    if rec.get("progress") is not None:
        bits.append(f"{100 * rec['progress']:.0f}%")
    if rec.get("done"):
        bits.append("DONE")
    return " ".join(bits)


def _format_sweep_bucket(rec) -> str:
    """One sweep-journal bucket record (sweepscope/journal.py): which
    bucket landed, its stage clocks, its compile count."""
    idx = rec.get("point_indices") or []
    bits = [f"[{rec.get('label', 'sweep')}-journal]",
            f"bucket {rec.get('bucket_index')}",
            f"({rec.get('bucket_kind')}, {len(idx)} pt"
            f"{'s' if len(idx) != 1 else ''})"]
    for stage in ("prepare_s", "compile_s", "run_s", "fetch_s"):
        v = rec.get(stage)
        if isinstance(v, (int, float)):
            bits.append(f"{stage[:-2]}={v:.2f}s")
    if rec.get("compile_count") is not None:
        bits.append(f"compiles={rec['compile_count']}")
    return " ".join(bits)


def _format_kernel_telem(rec) -> str:
    """One kernelscope telemetry record (kernelscope/report.py): the
    kernel, its rounds, the pad waste and the per-stage counter totals."""
    bits = [f"[{rec.get('label', 'kernelscope')}]",
            f"kernel={rec.get('kernel')}",
            f"rounds={rec.get('rounds')}"]
    if rec.get("pad_waste_frac") is not None:
        bits.append(f"pad_waste={rec['pad_waste_frac']:.3f}")
    totals = rec.get("stage_totals") or {}
    for stage in sorted(totals):
        c = totals[stage]
        bits.append(f"{stage}(hist={c.get('hist_visits')} "
                    f"quorum={c.get('quorum_passes')} "
                    f"coins={c.get('coin_draws')} "
                    f"hops={c.get('plane_hops')})")
    return " ".join(bits)


def _format_sweep_done(rec) -> str:
    bits = [f"[{rec.get('label', 'sweep')}-journal]",
            f"sweep complete: {rec.get('points_total')} points / "
            f"{rec.get('n_buckets')} buckets"]
    if rec.get("buckets_reused"):
        bits.append(f"({rec['buckets_reused']} journal-restored)")
    if rec.get("overlap_headroom_s") is not None:
        bits.append(f"overlap_headroom={rec['overlap_headroom_s']:.2f}s")
    bits.append("DONE")
    return " ".join(bits)


def _format_atlas_probe(rec) -> str:
    """One atlas search probe (atlas/search.py): the axis and generation,
    the probed value and its verdict."""
    bits = [f"[atlas:{rec.get('axis')}]",
            f"gen={rec.get('generation')}",
            f"{rec.get('axis')}={rec.get('value')}",
            f"verdict={rec.get('verdict')}"]
    if isinstance(rec.get("stall_frac"), (int, float)):
        bits.append(f"stall={rec['stall_frac']:.3f}")
    if rec.get("rounds_executed") is not None:
        bits.append(f"rounds={rec['rounds_executed']}")
    return " ".join(bits)


def _format_atlas_cliff(rec) -> str:
    """One cliff-refinement step: the bracketing interval after this
    generation's bisection, flagged when at the pinned tolerance."""
    bits = [f"[atlas:{rec.get('axis')}]"]
    if rec.get("generation") is not None:
        bits.append(f"gen={rec['generation']}")
    bits.append(f"cliff [{rec.get('lo')}, {rec.get('hi')}]")
    if isinstance(rec.get("width"), (int, float)):
        bits.append(f"width={rec['width']:g}")
    bits.append(f"{rec.get('lo_verdict')}->{rec.get('hi_verdict')}")
    if rec.get("converged"):
        bits.append("CONVERGED")
    return " ".join(bits)


def _format_atlas_heatmap(rec) -> str:
    """One 2D-slice heatmap document, rendered with atlas.render_heatmap;
    a torn or foreign one is printed raw."""
    from .atlas import render_heatmap
    try:
        return render_heatmap(rec)
    except (KeyError, TypeError, ValueError):
        return json.dumps(rec, sort_keys=True)


def _watch(args) -> int:
    """Tail a run's JSON-lines progress file (heartbeats, sweep-journal
    records, kernel telemetry, atlas records, interleaved or not): print
    each new record as it is appended, formatted by kind, an unknown kind
    raw; stop on a ``done: true`` record, on --no-follow after one pass,
    or after --timeout seconds of silence.  Touches no device.  Exit 0
    once a record was seen, 1 on a silent timeout."""
    from .atlas import CLIFF_KIND, HEATMAP_KIND, PROBE_KIND
    from .kernelscope.report import KERNEL_TELEM_KIND
    from .meshscope.heartbeat import HEARTBEAT_KIND, tail_records
    from .sweepscope.journal import BUCKET_KIND, DONE_KIND

    formatters = {HEARTBEAT_KIND: _format_heartbeat,
                  BUCKET_KIND: _format_sweep_bucket,
                  DONE_KIND: _format_sweep_done,
                  KERNEL_TELEM_KIND: _format_kernel_telem,
                  PROBE_KIND: _format_atlas_probe,
                  CLIFF_KIND: _format_atlas_cliff,
                  HEATMAP_KIND: _format_atlas_heatmap}
    seen = 0
    for rec in tail_records(args.path, poll_s=args.poll,
                            timeout_s=args.timeout,
                            follow=not args.no_follow,
                            stop_when_done=not args.keep_going):
        seen += 1
        fmt = formatters.get(rec.get("kind"))
        if fmt is not None:
            print(fmt(rec), flush=True)
        else:
            print(json.dumps(rec.get("raw", rec), sort_keys=True),
                  flush=True)
        if args.max_updates and seen >= args.max_updates:
            break
    if not seen:
        print(f"watch: no records in {args.path} within "
              f"{args.timeout}s (is the run armed with a heartbeat/"
              f"journal path?)",
              file=sys.stderr)
        return 1
    return 0


def _preset(args) -> int:
    from .sweep import baseline_configs, run_point
    cfgs = baseline_configs()
    if args.name not in cfgs:
        print(f"unknown preset {args.name!r}; choose from "
              f"{sorted(cfgs)}", file=sys.stderr)
        return 1
    pt = run_point(cfgs[args.name], device=args.device)
    print(json.dumps(pt.to_dict(), indent=1))
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="benor_tpu_torch")
    sub = ap.add_subparsers(dest="cmd")

    d = sub.add_parser("demo", help="the reference start.ts demo")
    d.add_argument("-n", type=int, default=10)        # start.ts:7
    d.add_argument("-f", type=int, default=4)         # start.ts:8
    d.add_argument("--backend", choices=("tpu", "express", "native"),
                   default="tpu")
    d.add_argument("--max-rounds", type=int, default=32)
    d.add_argument("--seed", type=int, default=0)
    _add_device_arg(d)

    s = sub.add_parser("sweep", help="rounds-vs-f curve")
    s.add_argument("--n", type=int, required=True)
    s.add_argument("--f-values", required=True,
                   help="comma-separated fault counts")
    s.add_argument("--trials", type=int, default=256)
    s.add_argument("--max-rounds", type=int, default=64)
    s.add_argument("--scheduler",
                   choices=("uniform", "biased", "adversarial", "targeted"),
                   default="uniform")
    s.add_argument("--coin", choices=("private", "common"), default="private")
    s.add_argument("--fault-model",
                   choices=("crash", "byzantine", "equivocate"),
                   default="crash")
    s.add_argument("--seed", type=int, default=0)
    _add_pallas_arg(s)
    _add_obs_args(s)
    s.add_argument("--balanced", action="store_true",
                   help="balanced inputs + zero crashes (the multi-round "
                        "science regime; default is the reference-style "
                        "iid-inputs/crash-faults workload)")
    s.add_argument("--batched", action="store_true",
                   help="run the curve through the batched engine "
                        "(sweep.run_curve_batched; the same summaries)")
    s.add_argument("--pipeline", action="store_true",
                   help="with --batched: build bucket k+1 on a worker "
                        "thread while bucket k runs (the same results)")
    s.add_argument("--out", help="write points to this JSON file")
    s.add_argument("--heartbeat-out", metavar="PATH",
                   help="with --batched and a heartbeat cadence "
                        "(--heartbeat-rounds), append progress records "
                        "here for `python -m benor_tpu_torch watch`")
    s.add_argument("--heartbeat-rounds", type=int, default=0,
                   help="arm the progress heartbeat at this round "
                        "cadence (0 = off); the batched engine beats "
                        "per bucket")
    s.add_argument("--journal", metavar="PATH",
                   help="with --batched: append one durable JSON-lines "
                        "record per completed bucket (the sweep journal "
                        "--resume restarts from)")
    s.add_argument("--resume", action="store_true",
                   help="with --journal: skip every bucket whose "
                        "fingerprint matches a journal record and "
                        "reassemble its points from disk")
    s.add_argument("--trace-out", metavar="PATH",
                   help="with --batched: write each bucket's span tree "
                        "(prepare / compile / execute / fetch, flow "
                        "links to its points) as a Chrome-trace/Perfetto "
                        "file")
    s.add_argument("--manifest-out", metavar="PATH",
                   help="with --batched: write the sweep manifest "
                        "(per-bucket stage clocks, the pipeline model, "
                        "the telescoping check)")
    _add_device_arg(s)

    c = sub.add_parser("coins", help="private vs common coin, adversarial")
    c.add_argument("--n", type=int, default=100)
    c.add_argument("--f", type=int, default=40)  # need F >> sqrt(N)
    c.add_argument("--trials", type=int, default=128)
    c.add_argument("--max-rounds", type=int, default=48)
    c.add_argument("--seed", type=int, default=0)
    _add_pallas_arg(c)
    c.add_argument("--eps", type=float, nargs="*",
                   help="also run weak_common coins at these deviation "
                        "probabilities (0 ~ common, 1 ~ private; the "
                        "termination transition sits at 1 - F/N)")
    _add_obs_args(c, record=False)
    _add_device_arg(c)

    a = sub.add_parser("audit",
                       help="run one witnessed config and machine-check "
                            "the Ben-Or invariants (audit.py)")
    a.add_argument("--n", type=int, default=100)
    a.add_argument("--f", type=int, default=25)
    a.add_argument("--trials", type=int, default=16)
    a.add_argument("--max-rounds", type=int, default=32)
    a.add_argument("--scheduler",
                   choices=("uniform", "biased", "adversarial", "targeted"),
                   default="uniform")
    a.add_argument("--coin", choices=("private", "common"),
                   default="private")
    a.add_argument("--fault-model",
                   choices=("crash", "byzantine", "equivocate"),
                   default="crash")
    a.add_argument("--balanced", action="store_true",
                   help="balanced inputs + zero crashes (live marked "
                        "faults under byzantine/equivocate) — the regime "
                        "where the safety adversaries bite")
    a.add_argument("--unanimous", type=int, choices=(0, 1), default=None,
                   help="run all-<v> inputs and arm the VALIDITY check "
                        "(any decision != v is a violation)")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--witness-trials", default=None,
                   help="comma-separated global trial ids to watch "
                        "(default: the first min(trials, 4))")
    a.add_argument("--witness-nodes", type=int, default=None,
                   help="how many nodes to watch — the first ceil(k/2) + "
                        "last floor(k/2) global ids (default: "
                        "min(n, 16))")
    a.add_argument("--audit-out", metavar="PATH",
                   help="write the witness bundle + audit verdict as one "
                        "JSON document (re-auditable offline via "
                        "audit.load_bundle)")
    a.add_argument("--max-violations", type=int, default=5,
                   help="violations printed before truncating (all land "
                        "in --audit-out)")
    _add_pallas_arg(a)
    _add_obs_args(a, record=False)
    _add_device_arg(a)

    t = sub.add_parser("trace",
                       help="run one recorded config, export a Chrome-"
                            "trace/Perfetto file of its round history")
    t.add_argument("--n", type=int, default=1000)
    t.add_argument("--f", type=int, default=250)
    t.add_argument("--trials", type=int, default=64)
    t.add_argument("--max-rounds", type=int, default=64)
    t.add_argument("--scheduler",
                   choices=("uniform", "biased", "adversarial", "targeted"),
                   default="uniform")
    t.add_argument("--coin", choices=("private", "common", "weak_common"),
                   default="private")
    t.add_argument("--fault-model",
                   choices=("crash", "byzantine", "equivocate"),
                   default="crash")
    t.add_argument("--balanced", action="store_true",
                   help="balanced inputs + zero crashes (live marked "
                        "faults under byzantine/equivocate) — the "
                        "multi-round science regime")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", default="benor_trace.json",
                   help="Chrome-trace output path (default "
                        "benor_trace.json)")
    _add_pallas_arg(t)
    _add_obs_args(t, record=False)   # trace implies --record
    _add_device_arg(t)

    p = sub.add_parser("preset", help="run a BASELINE.json preset config")
    p.add_argument("name")
    _add_device_arg(p)

    for name, (what, item) in UNPORTED_COMMANDS.items():
        sub.add_parser(name, help=f"not ported (ROADMAP Queue A item "
                                  f"{item})")

    at = sub.add_parser(
        "atlas",
        help="phase-boundary observatory: adaptive cliff search over "
             "the scenario grid (atlas/) -> kind:atlas_manifest + "
             "cliff-drift gate vs ATLAS_BASELINE.json; exit 2 on drift")
    at.add_argument("--searches", default="omission,partition,quorum",
                    help="comma-separated shipped searches to run "
                         "(default: all three — the omission stall "
                         "cliff, the partition liveness boundary, the "
                         "F >= N/2 quorum cliff)")
    at.add_argument("--axis", action="append", default=None,
                    metavar="SPEC",
                    help="instead of the shipped searches, hunt cliffs "
                         "on this '<name>:<lo>:<hi>[:<tol>]' axis over "
                         "the --n/--f/--trials/--max-rounds base "
                         "config (repeatable; see "
                         "atlas/scenario.AXIS_KINDS)")
    at.add_argument("--n", type=int, default=64,
                    help="base nodes for --axis/--heatmap searches")
    at.add_argument("--f", type=int, default=16)
    at.add_argument("--trials", type=int, default=8)
    at.add_argument("--max-rounds", type=int, default=16)
    at.add_argument("--seed", type=int, default=0)
    at.add_argument("--coarse", type=int, default=4,
                    help="coarse seeding-grid intervals per axis "
                         "(default 4 -> 5 grid points)")
    at.add_argument("--scale", type=float, default=1.0,
                    help="trial-count multiplier for the shipped "
                         "searches (cliff LOCATIONS are scale-free; "
                         "the gate refuses cross-scale compares)")
    at.add_argument("--no-forensics", action="store_true",
                    help="skip the per-cliff witness-armed audit and "
                         "minimal-repro emission")
    at.add_argument("--journal", metavar="PATH",
                    help="append atlas_probe/atlas_cliff records plus "
                         "the underlying sweep-journal bucket records "
                         "here (--resume restarts from it)")
    at.add_argument("--resume", action="store_true",
                    help="with --journal: restore every completed "
                         "generation's buckets from the journal and run "
                         "only the remainder")
    at.add_argument("--out-dir", metavar="DIR",
                    help="dump witness bundles + repro JSONs here")
    at.add_argument("--heatmap", metavar="SPEC_A,SPEC_B",
                    help="instead of a search: evaluate the 2D "
                         "axis_a x axis_b slice in ONE batched call "
                         "and render the stall/rounds heatmap "
                         "(--profile-out JSON rows, --trace-out "
                         "Perfetto counter tracks)")
    at.add_argument("--trace-out", metavar="PATH",
                    help="with --heatmap: write Perfetto counter "
                         "tracks (one per axis_b row) here")
    at.add_argument("--format", choices=("text", "json"),
                    default="text")
    at.add_argument("--profile-out", metavar="PATH",
                    help="write the manifest (or --heatmap document) "
                         "to this JSON file")
    at.add_argument("--baseline", metavar="PATH", default=None,
                    help="baseline manifest to gate against (default: "
                         "the committed ATLAS_BASELINE.json)")
    at.add_argument("--update-baseline", action="store_true",
                    help="write this capture as the new baseline "
                         "instead of gating against it")
    _add_obs_args(at, record=False)
    _add_device_arg(at)

    pf = sub.add_parser(
        "profile",
        help="the performance observatory: each ported regime's stages, "
             "footprint and device profile (perfscope), or with "
             "--kernels the round kernels' stage counters (kernelscope), "
             "gated against the committed baseline; exit 2 on regression")
    pf.add_argument("--n", type=int, default=None,
                    help="nodes (default: the profile scale — 256 on "
                         "the CPU, 1,000,000 on the card; --kernels: 256)")
    pf.add_argument("--trials", type=int, default=None)
    pf.add_argument("--max-rounds", type=int, default=None)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--regimes", default=None,
                    help="comma-separated subset of traced,fused_pallas,"
                         "sliced,batched_sweep (default: all four; "
                         "sharded is item 15; a subset skips the "
                         "baseline gate)")
    pf.add_argument("--steady-reps", type=int, default=2,
                    help="executions after the first averaged into the "
                         "steady timing (default 2)")
    pf.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format; json = the manifest")
    pf.add_argument("--profile-out", metavar="PATH",
                    help="write the manifest to this JSON file")
    pf.add_argument("--baseline", metavar="PATH", default=None,
                    help="baseline manifest to gate against (default: "
                         "the committed PERF_BASELINE.json, or "
                         "KERNEL_BASELINE.json with --kernels)")
    pf.add_argument("--update-baseline", action="store_true",
                    help="write this capture to --baseline PATH instead "
                         "of gating against it (never to a committed "
                         "baseline)")
    pf.add_argument("--timing-band", type=float, default=None,
                    help="also gate the machine-sensitive stage timings "
                         "at this ratio band (off by default)")
    pf.add_argument("--trace-dir", metavar="DIR", default=None,
                    help="wrap the capture in a torch.profiler trace "
                         "(TensorBoard / Perfetto) and export the metrics "
                         "registry's tracks beside it")
    pf.add_argument("--kernels", action="store_true",
                    help="kernelscope capture instead of the regimes: "
                         "the stage counters of both packed dispatches, "
                         "the traffic model and, on the card, the "
                         "kernels' time against their bound -> "
                         "kind:kernel_manifest, gated against "
                         "KERNEL_BASELINE.json (exit 2 on regression)")
    pf.add_argument("--telemetry-out", metavar="PATH", default=None,
                    help="with --kernels: append kind:kernel_telemetry "
                         "JSON-lines records here")
    _add_obs_args(pf, record=False)
    _add_device_arg(pf)

    sv = sub.add_parser("serve",
                        help="the asynchronous multi-tenant request "
                             "plane: HTTP+SSE job API coalescing "
                             "concurrent client jobs onto the warm "
                             "executor pool (serve/)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8400,
                    help="listen port (default 8400; 0 = ephemeral)")
    sv.add_argument("--max-batch-jobs", type=int, default=None,
                    help="coalescing ceiling: jobs a launch (default "
                         "serve.MAX_BATCH_JOBS, rounded up to a power "
                         "of two)")
    sv.add_argument("--trace-out", metavar="PATH", default=None,
                    help="arm span tracing and write the Perfetto trace "
                         "(request, batch and job stage spans, "
                         "flow-linked) here on shutdown")
    _add_device_arg(sv)

    ld = sub.add_parser("load",
                        help="load-test the request plane: concurrent "
                             "SSE clients -> serve manifest + baseline "
                             "gate (SERVE_BASELINE.json); exit 2 on "
                             "regression")
    ld.add_argument("--clients", type=int, default=1000,
                    help="concurrent clients (default 1000)")
    ld.add_argument("--url", default=None,
                    help="target a running `benor_tpu_torch serve` "
                         "instance (default: an in-process server on "
                         "--device, on an ephemeral port)")
    ld.add_argument("--job", default=None,
                    help="JSON JobSpec each client submits (default: "
                         "serve.loadgen.DEFAULT_JOB, a dyn-bucket "
                         "simulate; clients get distinct seeds)")
    ld.add_argument("--timeout", type=float, default=120.0,
                    help="per-client completion deadline in seconds")
    ld.add_argument("--ramp", type=float, default=0.0,
                    help="spread connection setup across this many "
                         "seconds (0 = thundering herd)")
    ld.add_argument("--max-batch-jobs", type=int, default=None,
                    help="coalescing ceiling of the in-process server "
                         "(ignored with --url)")
    ld.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format; json = the manifest")
    ld.add_argument("--profile-out", metavar="PATH",
                    help="write the serve manifest to this JSON file")
    ld.add_argument("--baseline", metavar="PATH", default=None,
                    help="baseline manifest to gate against (default: "
                         "the committed SERVE_BASELINE.json)")
    ld.add_argument("--update-baseline", action="store_true",
                    help="write this capture to --baseline PATH instead "
                         "of gating against it (never to a committed "
                         "baseline)")
    ld.add_argument("--timing-band", type=float, default=None,
                    help="also gate the machine-sensitive throughput/"
                         "p99 numbers at this ratio band (off by "
                         "default; see serve/gate.py)")
    ld.add_argument("--trace-out", metavar="PATH", default=None,
                    help="arm span tracing for the run and write the "
                         "Perfetto trace (request, batch and job stage "
                         "spans, flow-linked) here")
    _add_obs_args(ld, record=False)
    _add_device_arg(ld)

    w = sub.add_parser("watch",
                       help="tail a run's JSON-lines progress file: "
                            "heartbeats (rounds/sec, decided fraction, "
                            "ETA) and/or sweep-journal bucket records, "
                            "by kind; touches no device")
    w.add_argument("path", help="JSON-lines file (sweep "
                                "--heartbeat-out / --journal / "
                                "TpuNetwork.heartbeat_path; mixed kinds "
                                "interleave freely)")
    w.add_argument("--poll", type=float, default=0.2,
                   help="poll interval in seconds (default 0.2)")
    w.add_argument("--timeout", type=float, default=60.0,
                   help="give up after this many seconds without a new "
                        "record (default 60)")
    w.add_argument("--max-updates", type=int, default=0,
                   help="stop after printing this many records "
                        "(0 = until done/timeout)")
    w.add_argument("--no-follow", action="store_true",
                   help="print what is in the file now and exit "
                        "instead of tailing")
    w.add_argument("--keep-going", action="store_true",
                   help="do not stop at done: true records — an atlas "
                        "search journal carries one sweep_done per "
                        "refinement generation")

    rp = sub.add_parser(
        "replay",
        help="re-execute a kind:atlas_repro document bit-identically "
             "(digest + verdict pinned); exit 0 reproduced, 2 "
             "mismatch, 1 unreadable")
    rp.add_argument("path", help="repro JSON (atlas --out-dir emission "
                                 "or a manifest cliff's repro block "
                                 "saved to a file)")
    rp.add_argument("--format", choices=("text", "json"),
                    default="text")
    _add_device_arg(rp)

    r = sub.add_parser("results",
                       help="generate RESULTS/ (curves + presets artifact)")
    r.add_argument("--out", default="RESULTS")
    r.add_argument("--n", type=int, default=None,
                   help="study size (default: 1M on the card, 50k on "
                        "the CPU)")
    r.add_argument("--trials", type=int, default=None,
                   help="MC trials (default: 32 on the card, 8 on the "
                        "CPU)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--no-presets", action="store_true",
                   help="skip the BASELINE presets (quick smoke)")
    _add_device_arg(r)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    # bare `python -m benor_tpu_torch [-n N -f F ...]` == the start.ts demo
    if not argv or argv[0] not in ("demo", "sweep", "coins", "preset",
                                   "results", "trace", "audit", "atlas",
                                   "replay", "profile", "serve", "load",
                                   "watch", *UNPORTED_COMMANDS,
                                   "-h", "--help"):
        argv = ["demo"] + argv
    if argv[0] in UNPORTED_COMMANDS:
        unported(*UNPORTED_COMMANDS[argv[0]])
    args = ap.parse_args(argv)
    _refuse_unported(args)
    # the event-loop oracles and the tail are host programs: no device
    if not (args.cmd == "watch" or
            (args.cmd == "demo" and args.backend in ("express", "native"))):
        from .sim import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"benor_tpu_torch {args.cmd}: {e}", file=sys.stderr)
            return 1
    return {"demo": _demo, "sweep": _sweep, "coins": _coins,
            "preset": _preset, "results": _results, "trace": _trace,
            "audit": _audit, "atlas": _atlas, "replay": _replay,
            "profile": _profile, "serve": _serve, "load": _load,
            "watch": _watch}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
