"""ctypes bindings for the port's native C++ data routines:

* `csrc/tfrecord_index.cc`: the TFRecord framing/CRC scanner of the ETL
  (data/tfrecord.read_records);
* `csrc/batch_assembler.cc`: the fused gather + transpose + quantize of
  the training loop's K-step payloads (data/assembler.assemble_calls).

Counterpart of `pivp_tpu/data/native.py`, with two differences. Each
library is built with g++ at its first use into `pivp_tpu_torch/_build/`
(beside the CUDA kernels), under a name that hashes its source and
flags, so an unchanged tree reuses it; nothing is built at import. And a
failed build raises with the compiler's output: there is no silent
fallback to the Python paths, which stay as the plain versions the tests
hold these routines against.

Each entry point counts its calls (`index_records.calls`,
`assemble.calls`), as the kernel wrappers count their launches, so a
caller can show the native path was taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -ffp-contract=off keeps x*255+0.5 two roundings, as numpy computes it.
_BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
# The hardware CRC32-C instruction on x86-64; elsewhere the table path.
_SCANNER_FLAGS = (("-msse4.2",) if platform.machine() in ("x86_64", "AMD64")
                  else ())
_ASSEMBLER_FLAGS = ("-fopenmp",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _build(stem: str, extra: Tuple[str, ...]) -> Path:
    """g++-compile csrc/<stem>.cc into _build/ (skipped when the hashed
    library exists). Raises RuntimeError with the compiler's output."""
    src = CSRC / f"{stem}.cc"
    flags = _BASE_FLAGS + extra
    digest = hashlib.sha1(" ".join(flags).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {src.name} is built with g++ "
                           f"at first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def _load(stem: str, extra: Tuple[str, ...], bind) -> ctypes.CDLL:
    """The library of csrc/<stem>.cc, built and bound (`bind(lib)` sets
    its signatures) on first use."""
    with _lock:
        if stem not in _libs:
            lib = ctypes.CDLL(str(_build(stem, extra)))
            bind(lib)
            _libs[stem] = lib
        return _libs[stem]


def _bind_scanner(lib: ctypes.CDLL) -> None:
    ull_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_ulonglong))
    lib.tfr_index.restype = ctypes.c_longlong
    lib.tfr_index.argtypes = [ctypes.c_char_p, ctypes.c_int, ull_pp, ull_pp]
    lib.tfr_free.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.tfr_crc32c.restype = ctypes.c_uint
    lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong]


def _bind_assembler(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_longlong
    for fn in (lib.pivp_assemble_f32, lib.pivp_assemble_u8):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
                       ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The TFRecord scanner, built on first use."""
    return _load("tfrecord_index", _SCANNER_FLAGS, _bind_scanner)


def get_assembler_lib() -> ctypes.CDLL:
    """The batch assembler, built on first use."""
    return _load("batch_assembler", _ASSEMBLER_FLAGS, _bind_assembler)


def index_records(path: str, verify_crc: bool = True
                  ) -> List[Tuple[int, int]]:
    """Native scan of one tfrecord file: [(payload_offset, length), ...].
    Raises IOError on a missing file or corrupt framing/CRC."""
    lib = get_lib()
    offs = ctypes.POINTER(ctypes.c_ulonglong)()
    lens = ctypes.POINTER(ctypes.c_ulonglong)()
    index_records.calls += 1
    n = lib.tfr_index(os.fsencode(path), int(verify_crc),
                      ctypes.byref(offs), ctypes.byref(lens))
    if n == -1:
        raise IOError(f"cannot open {path}")
    if n == -2:
        raise IOError(f"corrupt tfrecord framing/CRC in {path}")
    try:
        return [(offs[i], lens[i]) for i in range(n)]
    finally:
        lib.tfr_free(offs)
        lib.tfr_free(lens)


def crc32c(data: bytes) -> int:
    lib = get_lib()
    return int(lib.tfr_crc32c(data, len(data)))


def assemble(images: np.ndarray, idx: np.ndarray,
             quantize: bool) -> np.ndarray:
    """images (N, T, ...) C-contiguous float32, idx (K, B) -> the
    time-major (K, T, B, ...) gather, uint8-quantized if `quantize`."""
    if not (isinstance(images, np.ndarray) and images.dtype == np.float32
            and images.flags["C_CONTIGUOUS"] and images.ndim >= 3):
        raise ValueError("the native assembler takes a C-contiguous "
                         "float32 (N, T, ...) array")
    if idx.ndim != 2:
        raise ValueError(f"idx must be (K, B), got shape {idx.shape}")
    lib = get_assembler_lib()
    k, b = idx.shape
    t = images.shape[1]
    row = int(np.prod(images.shape[2:]))
    out = np.empty((k, t, b) + images.shape[2:],
                   np.uint8 if quantize else np.float32)
    flat = np.ascontiguousarray(idx.reshape(-1), np.int64)
    if flat.size and not 0 <= flat.min() <= flat.max() < images.shape[0]:
        raise IndexError(f"sequence index out of range [0, "
                         f"{images.shape[0]})")
    fn = lib.pivp_assemble_u8 if quantize else lib.pivp_assemble_f32
    assemble.calls += 1
    fn(images.ctypes.data, flat.ctypes.data, k, b, t, row, out.ctypes.data)
    return out


index_records.calls = 0
assemble.calls = 0
