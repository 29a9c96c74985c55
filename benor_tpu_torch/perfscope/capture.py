"""Stage-timed capture -> PerfReport (port of
benor_tpu/perfscope/capture.py).

A capture runs one regime through the stages eager PyTorch has, each
measured apart and recorded in ``utils.metrics.REGISTRY``:

  build           the kernel library's nvcc build and load
                  (ops/_build.py), where the regime runs a kernel on the
                  card: ``compile_s``, and ``backend_compiles`` the
                  ``library_events`` it added (0 warm, 0 on the CPU);
  first execute   one run, timed to a device synchronize;
  steady execute  the mean of ``steady_reps`` more runs, timed alike.

Eager torch traces nothing, so ``trace_lower_s`` is 0.0.  The memory
fields: ``argument_bytes`` / ``output_bytes`` are the ``nbytes`` of the
input and output tensors (on the card and on the CPU alike);
``peak_bytes`` is the caching allocator's ``max_memory_allocated`` over
the steady executions (reset before them), and ``temp_bytes`` that peak
less the arguments and outputs; on the CPU, which keeps no such
statistic, both are None, as are ``alias_bytes`` and
``generated_code_bytes`` everywhere (XLA's).  No executable cost model
exists for a sequence of torch ops and kernel launches, so ``flops``,
``bytes_accessed``, ``transcendentals`` and the roofline keys are None.
In their place one ``torch.profiler`` pass over one more execution on the
card (``profile_pass``, apart from the timed ones) gives the device's busy
seconds, its busy share of the steady execution, the launches of the
port's kernels by name and the top device entries; on the CPU they are
None.  A capture runs the same code as an unprofiled run and keeps
nothing, so a later run's results and ``library_events`` are unchanged.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..utils.metrics import REGISTRY

#: PerfReport / manifest schema version (the JAX package's v2 documents).
REPORT_VERSION = 2

#: A port kernel's entry in a profile: its name, its template arguments.
_PORT_KERNEL = re.compile(r"(\w+_kernel)(<[^>]*>)?\(")

#: The port's kernels, as their names start (csrc/*.cu).
PORT_KERNELS = ("proposal_hist", "vote_commit", "fused", "cf_counts",
                "equiv_counts", "coin_flips", "weak_coin_flips",
                "dense_counts")


@dataclasses.dataclass
class PerfReport:
    """One regime's stages, footprint and profile (the JAX key set, then
    the profiler pass's fields)."""

    regime: str
    platform: str
    device_kind: str
    # the captured workload
    n_nodes: int
    n_faulty: int
    trials: int
    max_rounds: int
    seed: int
    rounds_executed: int
    # stage timings (seconds)
    trace_lower_s: float
    compile_s: float
    first_execute_s: float
    steady_execute_s: float
    steady_reps: int
    backend_compiles: int
    # XLA's cost model: None (no executable cost model in eager torch)
    flops: Optional[float]
    bytes_accessed: Optional[float]
    transcendentals: Optional[float]
    # memory footprint (bytes; the module docstring says what each is)
    argument_bytes: int
    output_bytes: int
    temp_bytes: Optional[int]
    alias_bytes: Optional[int]
    generated_code_bytes: Optional[int]
    peak_bytes: Optional[int]
    # roofline placement of XLA's cost model: None
    arithmetic_intensity: Optional[float]
    achieved_gbps: Optional[float]
    hbm_peak_gbps: Optional[float]
    hbm_util: Optional[float]
    ridge_flop_per_byte: Optional[float]
    bound: Optional[str]
    # the profiler pass (None on the CPU)
    device_busy_s: Optional[float] = None
    device_busy_share: Optional[float] = None
    kernel_launches: Optional[Dict[str, int]] = None
    top_device: Optional[List[list]] = None
    #: regime-specific facts (scheduler, coin, ...)
    extra: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CaptureResult:
    """One regime's measured stages and the first execution's outputs."""

    compile_s: float
    backend_compiles: int
    first_execute_s: float
    steady_execute_s: float
    steady_reps: int
    argument_bytes: int
    output_bytes: int
    peak_bytes: Optional[int]
    profile: Optional[dict]
    out: Any


def _nbytes(obj) -> int:
    """Bytes of every tensor in a (nested) tuple, list, dict or dataclass."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def port_kernel_label(key: str, ours=PORT_KERNELS) -> Optional[str]:
    """A profile entry's port-kernel label (its name and template
    arguments), or None when the entry is not one of ``ours``."""
    m = _PORT_KERNEL.search(key)
    if m and any(k in m.group(1) for k in ours):
        return "".join(g for g in m.groups() if g)
    return None


def profile_pass(run: Callable[[], Any], ours=PORT_KERNELS,
                 torch_ops: bool = False) -> dict:
    """One ``torch.profiler`` pass (CPU and CUDA activity) over ``run()``
    on the card -> its device entries, each (name, total device µs,
    launches), largest first: ``device`` every device-side entry (an aten
    op's entry repeats its kernels' time, so only device events count),
    ``ours`` the entries of the ``ours`` kernels under their labels,
    ``busy_us`` their sum, and with ``torch_ops`` ``torch_ops`` the aten
    ops by their kernels' device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    evs = sorted((e for e in avgs
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and _device_us(e) > 0), key=_device_us, reverse=True)
    out = {
        "busy_us": sum(_device_us(e) for e in evs),
        "device": [(e.key, _device_us(e), e.count) for e in evs],
        "ours": [(port_kernel_label(e.key, ours), _device_us(e), e.count)
                 for e in evs if port_kernel_label(e.key, ours)],
    }
    if torch_ops:
        ops = sorted((e for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.key.startswith("aten::") and _device_us(e) > 0),
                     key=_device_us, reverse=True)
        out["torch_ops"] = [(e.key, _device_us(e), e.count) for e in ops]
    return out


def profile_fields(prof: Optional[dict], steady_s: float,
                   top: int = 8) -> dict:
    """A ``profile_pass`` result -> the PerfReport's profiler fields
    (all None without a pass)."""
    if prof is None:
        return dict(device_busy_s=None, device_busy_share=None,
                    kernel_launches=None, top_device=None)
    busy_s = prof["busy_us"] / 1e6
    launches: Dict[str, int] = {}
    for label, _, count in prof["ours"]:
        launches[label] = launches.get(label, 0) + int(count)
    return dict(
        device_busy_s=round(busy_s, 6),
        device_busy_share=(round(busy_s / steady_s, 6) if steady_s > 0
                           else None),
        kernel_launches=launches,
        top_device=[[k[:60], round(us / 1e3, 4), int(c)]
                    for k, us, c in prof["device"][:top]])


def capture_stages(label: str, run: Callable[[], Any], args, device, *,
                   needs_library: bool = False, steady_reps: int = 2,
                   profile: bool = True) -> CaptureResult:
    """Measure every stage of ``run()`` (a regime's whole execution on
    ``args``, which it reads) on ``device``.  ``needs_library``: the run
    launches the port's kernels on the card, so the build stage loads the
    kernel library; ``profile``: make the profiler pass on the card.
    Execution timers feed ``perfscope.<label>.first_execute`` /
    ``.steady_execute``, the build ``perfscope.<label>.compile``."""
    from ..ops import _build

    device = torch.device(device)
    events0 = _build.library_events
    t0 = time.perf_counter()
    if needs_library and device.type == "cuda":
        _build.load_library()
    compile_s = time.perf_counter() - t0
    compiles = _build.library_events - events0
    _sync(device)
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    first_s = time.perf_counter() - t0
    peak = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steady_reps):
        run()
    _sync(device)
    steady_s = (time.perf_counter() - t0) / max(steady_reps, 1)
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
    prof = (profile_pass(run) if profile and device.type == "cuda"
            else None)
    REGISTRY.timer(f"perfscope.{label}.compile").record(compile_s)
    REGISTRY.timer(f"perfscope.{label}.first_execute").record(first_s)
    REGISTRY.timer(f"perfscope.{label}.steady_execute").record(steady_s)
    return CaptureResult(compile_s=compile_s, backend_compiles=compiles,
                         first_execute_s=first_s, steady_execute_s=steady_s,
                         steady_reps=steady_reps,
                         argument_bytes=_nbytes(args),
                         output_bytes=_nbytes(out), peak_bytes=peak,
                         profile=prof, out=out)


def build_report(regime: str, cfg, cap: CaptureResult,
                 rounds_executed: int, device,
                 extra: Optional[dict] = None) -> PerfReport:
    """A CaptureResult and its SimConfig -> the serializable PerfReport."""
    from ..sim import device_identity

    platform, kind = device_identity(device)
    temp = None
    if cap.peak_bytes is not None:
        temp = max(0, cap.peak_bytes - cap.argument_bytes
                   - cap.output_bytes)
    return PerfReport(
        regime=regime, platform=platform, device_kind=kind,
        n_nodes=cfg.n_nodes, n_faulty=cfg.n_faulty, trials=cfg.trials,
        max_rounds=cfg.max_rounds, seed=cfg.seed,
        rounds_executed=int(rounds_executed),
        trace_lower_s=0.0,
        compile_s=round(cap.compile_s, 6),
        first_execute_s=round(cap.first_execute_s, 6),
        steady_execute_s=round(cap.steady_execute_s, 6),
        steady_reps=cap.steady_reps,
        backend_compiles=cap.backend_compiles,
        flops=None, bytes_accessed=None, transcendentals=None,
        argument_bytes=cap.argument_bytes, output_bytes=cap.output_bytes,
        temp_bytes=temp, alias_bytes=None, generated_code_bytes=None,
        peak_bytes=cap.peak_bytes,
        arithmetic_intensity=None, achieved_gbps=None, hbm_peak_gbps=None,
        hbm_util=None, ridge_flop_per_byte=None, bound=None,
        **profile_fields(cap.profile, cap.steady_execute_s),
        extra=dict(extra or {}))
