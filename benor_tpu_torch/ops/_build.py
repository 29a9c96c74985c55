"""Build and load the CUDA kernels: nvcc -> shared library -> ctypes.

At first use the sources under ``benor_tpu_torch/csrc/`` are compiled for
Hopper (``sm_90a``) into ``build/benor_tpu_torch/`` at the root of the
checkout — one ``nvcc`` per source, all started together, then one link —
into one library per hash of the sources and flags, and loaded with
ctypes.  The kernels have a plain C interface, so no PyTorch header is
compiled and a build takes seconds.  A failed build raises.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into one
fused operation: the kernels then round op by op, as torch's elementwise
ops do, and agree bit for bit with their plain versions on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "benor_tpu_torch"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float

#: Kernel-library builds (an nvcc run) and loads (the library opened and
#: bound) made by this process so far: the sweep engine's compile count.
library_events = 0

#: argtypes of every C entry point in csrc/*.cu.
SIGNATURES = {
    "benor_round_blocks": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "benor_proposal_hist": [_P, _P, _P, _P, _I, _I, _I, _U, _U, _U, _U, _U,
                            _U, _F, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                            _I, _P, _P],
    "benor_vote_commit": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                          _U, _U, _U, _U, _U, _U, _I, _F, _F, _F, _I, _I,
                          _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    "benor_fused_round": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                          _U, _U, _U, _U, _U, _U, _U, _U, _I, _F, _F, _F,
                          _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
                          _P, _P],
    "benor_fused_fits": [_I, _I, _I, _I, _I, _I, _P],
    "benor_hist_wave": [_I, _P],
    "benor_cf_counts": [_P, _P, _I, _I, _I, _U, _U, _F, _P],
    "benor_coin_flips": [_P, _I, _I, _I, _U, _U, _P],
    "benor_equiv_counts": [_P, _P, _P, _I, _I, _I, _U, _U, _U, _U, _F,
                           _P],
    "benor_weak_coin_flips": [_P, _P, _I, _I, _I, _U, _U, _F, _P],
    "benor_dense_counts": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the default toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _run_timed(cmd: list[str]):
    """Run one command -> (CompletedProcess, wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    return res, time.perf_counter() - t0


def _run_all(cmds: list[list[str]]) -> list[float]:
    """Run the commands side by side, then raise on the first that failed
    -> each one's wall seconds."""
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        done = list(pool.map(_run_timed, cmds))
    for res, _ in done:
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(res.args)}\n{res.stdout}\n"
                               f"{res.stderr}")
    return [sec for _, sec in done]


def compile_library(flags: list[str], out_dir: Path) -> Path:
    """Compile csrc/*.cu with ``flags`` (one nvcc per source, in parallel)
    and link them into one shared library under ``out_dir``, cached by a
    hash of the flags and sources -> its path."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = out_dir / f"libbenor_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    global library_events
    library_events += 1
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    secs = _run_all([[nvcc_path(), *flags, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    out.with_suffix(".json").write_text(json.dumps(
        {src.name: round(sec, 2) for src, sec in zip(sources(), secs)}))
    os.replace(tmp, out)
    return out


def build_seconds(path: Path) -> dict:
    """{source: wall seconds of its nvcc} of the build that made the
    library at ``path`` (each source compiled side by side)."""
    return json.loads(path.with_suffix(".json").read_text())


def build() -> Path:
    """The port's kernel library, built with ``FLAGS`` -> its path."""
    return compile_library(FLAGS, BUILD_DIR)


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernel library and set every entry point's argtypes."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    global library_events
    lib = bind(build())
    library_events += 1
    return lib
