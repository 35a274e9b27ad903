"""Flat-npz save/load of the port's parameters and optimizer state, and
the run directory.

Counterpart of the npz and run-directory parts of
`pivp_tpu/utils/checkpoint.py`: the same '/'-joined keys, and the files
hold the JAX package's weight layouts (utils/weights.py maps them), so a
`training-<tag>.npz` or `state-<tag>.npz` written by either package
loads into the other, for the CDNA, DNA and STP heads (per-mask STP
projections under `head/identity_params/<i>/`). A run directory
`<date>-<TYPE>-<batch>/` holds those files, the metric-curve `.npy`
files and a `version` file stamping the git commit. The Chainer-layout
converter comes in a later slice.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, Optional

import numpy as np

from pivp_tpu_torch.utils import weights


def flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's nested parameter dict -> '/'-keyed numpy arrays in the
    JAX package's layouts (the npz contract)."""
    return weights.to_jax_params(tree)


def save_npz(path: str, tree: Dict[str, Any]) -> None:
    """Write atomically: to a temp file in the same directory, then
    os.replace, so a crash mid-write never leaves a truncated file at the
    final name."""
    out = path if path.endswith(".npz") else path + ".npz"
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(tmp, out)


def load_npz_into(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Load a flat npz into the structure of `template`: same keys and
    shapes, each tensor on the template tensor's device and dtype."""
    with np.load(path) as data:
        stored = weights.flatten(weights.from_jax_params(dict(data)))
    out = {}
    for key, leaf in weights.flatten(template).items():
        if key not in stored:
            raise KeyError(f"checkpoint missing key {key}")
        value = stored[key]
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(leaf.shape)}")
        out[key] = value.to(device=leaf.device, dtype=leaf.dtype)
    return weights.unflatten(out)


def npz_keys(path: str):
    """List checkpoint keys."""
    with np.load(path) as data:
        return sorted(data.keys())


def git_version() -> Optional[str]:
    """Branch + commit provenance stamp, or None outside a git checkout
    (or without git)."""
    try:
        def run(args):
            return subprocess.run(["git"] + args, capture_output=True,
                                  text=True, check=True,
                                  timeout=30).stdout.strip()
        return run(["rev-parse", "--abbrev-ref", "HEAD"]) + "\n" + \
            run(["rev-parse", "HEAD"])
    except (OSError, subprocess.SubprocessError):
        return None


def prepare_run_dir(output_dir: str, run_name: str) -> str:
    """Create `output_dir/run_name` (with its `version` stamp) if it does
    not exist yet; return its path."""
    save_dir = os.path.join(output_dir, run_name)
    if not os.path.exists(save_dir):
        os.makedirs(save_dir, exist_ok=True)
        version = git_version()
        if version is not None:
            with open(os.path.join(save_dir, "version"), "w") as f:
                f.write(version + "\n")
    return save_dir
