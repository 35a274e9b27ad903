"""Build and load the port's CUDA kernels.

Every source in `pivp_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`
process, all started together, for `sm_90a` (Hopper), and the objects
are linked into one shared library with a plain C interface, loaded with
ctypes. Nothing here runs when the module is imported: the first kernel
launch builds the library, into `pivp_tpu_torch/_build/` under a name
that hashes the sources and flags, so an unchanged tree reuses it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; each returns the cudaError_t of its launch.
SIGNATURES = {
    # x, w, y, B, H, W, C, K, rows, cols, smem, bf16, device, stream
    "pivp_local_apply_fwd": (_P, _P, _P) + (_I,) * 10 + (_P,),
    # x, g, dw, B, H, W, C, K, rows, cols, smem, bf16, device, stream
    "pivp_local_apply_bwd_w": (_P, _P, _P) + (_I,) * 10 + (_P,),
    # w, g, dx, B, H, W, C, K, rows, cols, smem, bf16, device, stream
    "pivp_local_apply_bwd_x": (_P, _P, _P) + (_I,) * 10 + (_P,),
    # gates, c, new_c, new_h, rows, C, forget_bias, bf16, device, stream
    "pivp_lstm_gates_fwd": (_P, _P, _P, _P, ctypes.c_int64, _I,
                            ctypes.c_float, _I, _I, _P),
    # gates, c, g_c (or null), g_h (or null), dgates, dc, rows, C,
    # forget_bias, bf16, device, stream
    "pivp_lstm_gates_bwd": (_P, _P, _P, _P, _P, _P, ctypes.c_int64, _I,
                            ctypes.c_float, _I, _I, _P),
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float           # wall time of this build; 0.0 when reused
    ptxas: List[str]         # `-Xptxas -v` register / spill lines


_loaded: Optional[Tuple[ctypes.CDLL, BuildInfo]] = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit on the GPU host")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build(force: bool = False) -> BuildInfo:
    """Compile csrc/*.cu into one shared library (skipped when the
    hashed library exists, unless `force`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libpivp_kernels_{_digest()}.so"
    if lib.exists() and not force:
        return BuildInfo(lib, 0.0, [])
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *CFLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        ptxas += [f"{src.name}: {line.strip()}" for line in out.splitlines()
                  if "registers" in line or "spill" in line]
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return BuildInfo(lib, time.perf_counter() - t0, ptxas)


def load(force_build: bool = False) -> Tuple[ctypes.CDLL, BuildInfo]:
    """The kernel library with typed entry points, built on first use."""
    global _loaded
    if _loaded is None or force_build:
        info = build(force=force_build)
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = (lib, info)
    return _loaded


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
