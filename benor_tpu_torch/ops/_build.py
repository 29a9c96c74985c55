"""Build and load the CUDA kernels: nvcc -> shared library -> ctypes.

At first use the sources under ``benor_tpu_torch/csrc/`` are compiled for
Hopper (``sm_90a``) into ``build/benor_tpu_torch/`` at the root of the
checkout, one library per hash of the sources and flags, and loaded with
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
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "benor_tpu_torch"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float

#: argtypes of every C entry point in csrc/round_kernels.cu.
SIGNATURES = {
    "benor_round_blocks": [_I],
    "benor_proposal_hist": [_P, _P, _P, _I, _I, _I, _U, _U, _F, _I, _I, _P],
    "benor_vote_commit": [_P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _U, _U,
                          _I, _F, _F, _I, _I, _I, _P],
    "benor_fused_round": [_P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _U, _U,
                          _U, _U, _I, _F, _F, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the default toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def compile_library(flags: list[str], out_dir: Path) -> Path:
    """Compile csrc/*.cu with ``flags`` into one shared library under
    ``out_dir``, cached by a hash of the flags and sources -> its path."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = out_dir / f"libbenor_round_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


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
    return bind(build())
