"""What nvcc makes of the round kernels and the histogram kernels:
registers, spills and shared memory (``-Xptxas -v``), the static SASS mix
by class (``cuobjdump -sass``), and each pipe's floor for a number of
lanes at a clock.

The pipes and their rates are those of compute capability 9.0: the lanes
a clock an SM from the CUDA C++ Programming Guide's table of arithmetic
instruction throughput, and which pipe an opcode issues to from the pipe
definitions of NVIDIA's Nsight Compute Kernel Profiling Guide (``alu``:
integer and logic work but IMAD / IMUL, and the f32 compares, min / max
and selects; ``fmaheavy``: IMAD, IMUL and IDP besides f32 multiply-adds).

Used by ``chip_smoke.py`` and ``round_stats.py`` on a machine with the CUDA
toolkit; the simulation never imports it.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path

from . import _build

ROUND_KERNELS = ("proposal_hist_kernel", "vote_commit_kernel",
                 "fused_round_kernel", "fused_cluster_kernel")
HIST_KERNELS = ("cf_counts_kernel", "equiv_counts_kernel")
COIN_KERNELS = ("coin_flips_kernel", "weak_coin_flips_kernel")
# Per-word loops that make up one pass of a kernel, where there is more
# than one: the fused round walks its words once a phase.
LOOPS = {"fused_round_kernel": 2, "fused_cluster_kernel": 2}
FUSED_KERNELS = ("fused_round_kernel", "fused_cluster_kernel")
# The round kernels' template parameters, in order (csrc/round_body.cuh):
# a report names each instantiation but the main path's (every parameter
# 0) by them, as "vote_commit_kernel<delivered,common>" or
# "vote_commit_kernel<sampled,private,recover>".
MODE_PARAMS = {"proposal_hist_kernel": ("counts", "pop", "fault"),
               "vote_commit_kernel": ("counts", "coin", "pop", "fault"),
               "fused_round_kernel": ("coin", "equiv", "fault"),
               "fused_cluster_kernel": ("coin", "equiv", "fault")}
_MODE_NAMES = {"counts": ("sampled", "delivered", "camps"),
               "coin": ("private", "common", "weak_common"),
               "pop": ("", "honest", "equiv"),
               "equiv": ("", "equiv"),
               "fault": ("", "crash_at", "recover")}

# SASS opcodes by class.  Opcodes of the uniform datapath (U*) that are not
# named here count as "uniform".
SASS_CLASSES = {
    "integer": {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "IMAD",
                "IMUL", "ISETP", "LEA", "IMNMX", "SEL", "PRMT", "IABS",
                "BMSK", "SGXT", "BREV", "FLO", "IDP", "BFE", "BFI", "VIADD",
                "VIMNMX"},
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK",
             "FRND", "FSET", "FSWZADD"},
    "mufu": {"MUFU"},
    "conversion": {"F2I", "I2F", "F2F", "I2I", "F2FP", "I2FP", "F2IP"},
    "branch": {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
               "BREAK", "WARPSYNC", "NANOSLEEP", "YIELD", "BPT", "KILL"},
    "vote_popc_shuffle": {"VOTE", "VOTEU", "POPC", "SHFL", "REDUX",
                          "MATCH"},
    "load_store": {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL",
                   "LDC", "ATOM", "ATOMS", "ATOMG", "RED", "LDSM"},
}
# Integer opcodes that issue to the FMA-heavy pipe; the rest of the
# integer class, and the f32 compares, min / max and selects, issue to the
# ALU (Nsight Compute Kernel Profiling Guide, pipelines "alu" and
# "fmaheavy").  sm_90's VIADD and VIMNMX are not named there: they are
# counted with the ALU's adds and min / max.
FMA_HEAVY = {"IMAD", "IMUL", "IDP"}
FP32_ARITH = {"FADD", "FMUL", "FFMA"}
# Warp lanes a clock an SM can take, compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions): one
# instruction a clock from each of 4 schedulers; f32 add/mul/fma 128;
# integer add/logic/shift, every compare/min/max/select, and integer
# multiply-add 64 each, on two pipes that run side by side (the ALU, and
# the FMA-heavy half of the f32 lanes, so f32 work and IMAD share 128
# lanes: the joint floor); MUFU and conversions 16; population count 16;
# one load/store unit instruction a clock.
PIPES = {
    "issue": (128, None),
    "fp32 add/mul/fma": (128, FP32_ARITH),
    "alu": (64, (SASS_CLASSES["integer"] - FMA_HEAVY)
            | {"FMNMX", "FSETP", "FSEL", "FCHK", "FSET"}),
    "fma-heavy (imad)": (64, FMA_HEAVY),
    "fp32 + imad (joint)": (128, FP32_ARITH | FMA_HEAVY),
    "mufu + conversion": (16, SASS_CLASSES["mufu"]
                          | SASS_CLASSES["conversion"]),
    "popc": (16, {"POPC"}),
    "load/store": (32, SASS_CLASSES["load_store"]),
}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                   r"(\S*)\s*([^;]*);")


def template_args(mangled: str, tag: str) -> tuple:
    """The integer and bool template arguments of the kernel whose
    length-prefixed name ``tag`` the mangled name holds (() for a kernel
    that is no template)."""
    rest = mangled[mangled.index(tag) + len(tag):]
    m = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)
    if not m:
        return ()
    return tuple(int(v) for v in re.findall(r"L[a-z]+(\d+)E", m.group(1)))


def mode_label(name: str, args: tuple) -> str:
    """A kernel instantiation's report name: the kernel's name, and for an
    instantiation with a mode other than the main path's its modes."""
    if not any(args):
        return name
    parts = [_MODE_NAMES[p][v]
             for p, v in zip(MODE_PARAMS.get(name, ()), args)]
    return f"{name}<{','.join(p for p in parts if p)}>"


def sass_class(op: str) -> str:
    for cls, ops in SASS_CLASSES.items():
        if op in ops:
            return cls
    return "uniform" if op.startswith("U") else "other"


def parse_ptxas(text: str) -> dict:
    """``-Xptxas -v`` output -> {mangled entry: {registers, spill_stores,
    spill_loads, smem, stack}}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled function: [(addr, opcode,
    operands, predicated)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(5).strip(),
                        bool(m.group(2))))
    return funcs


def _mix(insns) -> dict:
    mix = {}
    for _, op, _, _ in insns:
        cls = sass_class(op)
        mix[cls] = mix.get(cls, 0) + 1
    mix["total"] = len(insns)
    return mix


def _ops(insns) -> dict:
    ops = {}
    for _, op, _, _ in insns:
        ops[op] = ops.get(op, 0) + 1
    return ops


def sections(insns, loops: int = 1) -> dict:
    """A function's instructions -> {"all", "body", "loop"}: all of them;
    those up to the first unpredicated EXIT (the slow paths of IEEE divide
    and square root sit after it); and the spans of the ``loops`` largest
    outermost backward branches in the body (the per-word loops), if there
    are any."""
    body = insns
    for i, (_, op, _, pred) in enumerate(insns):
        if op == "EXIT" and not pred:
            body = insns[:i + 1]
            break
    spans = []
    for addr, op, args, _ in body:
        if op != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= addr:
            continue
        spans.append((int(m.group(1), 16), addr))
    outer = [a for a in spans
             if not any(b != a and b[0] <= a[0] and a[1] <= b[1]
                        for b in spans)]
    outer = sorted(outer, key=lambda sp: sp[0] - sp[1])[:loops]
    out = {"all": insns, "body": body}
    if outer:
        out["loop"] = [x for x in body
                       if any(lo <= x[0] <= hi for lo, hi in outer)]
    return out


def resource_report(src: Path, out_dir: Path, kernels=ROUND_KERNELS) -> dict:
    """Build one CUDA source to a cubin with the port's flags and
    ``-Xptxas -v`` -> {kernel: {registers, spills, smem, sass: {section:
    class counts}, ops: opcode counts of one pass of its loop}} for every
    instantiation of the ``kernels`` it holds, under its ``mode_label``
    (the main path's under the kernel's name)."""
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / f"{src.stem}.{os.getpid()}.cubin"
    flags = [f for f in _build.FLAGS if f not in ("-Xcompiler", "-fPIC")]
    res = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
                          str(cubin), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc -cubin failed:\n{res.stdout}\n{res.stderr}")
    ptxas = parse_ptxas(res.stdout + res.stderr)
    sass = parse_sass(subprocess.run([cuobjdump, "-sass", str(cubin)],
                                     capture_output=True, text=True,
                                     check=True).stdout)
    cubin.unlink()
    report = {}
    for name in kernels:
        # the mangled name's length prefix keeps coin_flips_kernel apart
        # from weak_coin_flips_kernel
        tag = f"{len(name)}{name}"
        for key in sorted(k for k in ptxas if tag in k and k in sass):
            label = mode_label(name, template_args(key, tag))
            info = dict(ptxas[key])
            secs = sections(sass[key], LOOPS.get(name, 1))
            info["sass"] = {s: _mix(v) for s, v in secs.items()}
            # one pass: the per-word or per-node loop where the kernel has
            # one, else the body
            info["ops"] = _ops(secs.get("loop", secs["body"]))
            report[label] = info
    return report


def pipe_floors(mix_ops: dict, passes: float, sms: int,
                clk_mhz: float) -> dict:
    """Opcode counts of one pass of a kernel's loop -> {pipe: floor ms} for
    ``passes`` passes on ``sms`` SMs at ``clk_mhz``."""
    out = {}
    for pipe, (rate, ops) in PIPES.items():
        n = sum(c for op, c in mix_ops.items() if ops is None or op in ops)
        out[pipe] = n * passes / (rate * sms * clk_mhz * 1e6) * 1e3
    return out


def print_resources(tag: str, resources: dict, lanes: int, sms: int,
                    mhz: float, lanes_a_pass: int = 1,
                    latency_ms: float | None = None):
    """The step-1 lines of one checkout (``resource_report``'s dict, or
    some of its kernels): resources and SASS classes of each kernel, and
    its pipe floors for ``lanes`` lanes at ``mhz``, a pass of a coin
    kernel's loop taking ``lanes_a_pass`` lanes (the checkout's
    ``hist.COIN_NODES``; a pass of the fused round is one word through both
    phases).  ``latency_ms``, the latency probe's measured time, is
    printed beside the floors."""
    for name, info in resources.items():
        print(f"[ptxas] {tag} {name}: {info.get('registers')} registers, "
              f"spill stores {info.get('spill_stores')} B, spill loads "
              f"{info.get('spill_loads')} B, stack {info.get('stack')} B, "
              f"smem {info.get('smem')} B")
        for sec, mix in info["sass"].items():
            print(f"[sass] {tag} {name} {sec}: "
                  + ", ".join(f"{k} {v}" for k, v in sorted(mix.items())))
        per = lanes_a_pass if name in COIN_KERNELS else 1
        floors = pipe_floors(info["ops"], lanes / per, sms, mhz)
        top = sorted(info["ops"].items(), key=lambda kv: -kv[1])[:16]
        probe = ("" if latency_ms is None
                 else f"; latency probe {latency_ms:.4f} ms")
        print(f"[pipes] {tag} {name} at {mhz:.0f} MHz, {sms} SMs, {lanes} "
              f"lanes, {per} a pass: " + ", ".join(f"{p} {v:.4f} ms"
                                     for p, v in floors.items())
              + "; top opcodes " + ", ".join(f"{k} {v}" for k, v in top)
              + probe)
