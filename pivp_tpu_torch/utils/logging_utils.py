"""Logging setup, per-frame summary strings and per-epoch statistics.

The port's own copy of `pivp_tpu/utils/logging_utils.py`: the
reference's logging format and the `<prefix>_recon_cost<i>` /
`_psnr<i>` / `_state_cost<i>` / `_psnr_all` / `_loss` summary naming.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

LOG_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(level=level, format=LOG_FORMAT)


def frame_summaries(prefix: str, metrics: Dict[str, np.ndarray]) -> List[str]:
    """Build per-frame summary strings matching the reference's
    `<prefix>_recon_cost<i> / _psnr<i> / _state_cost<i> / _psnr_all /
    _loss` naming (train_model.py:744-759)."""
    out: List[str] = []
    recon = np.asarray(metrics["recon_costs"])
    psnr = np.asarray(metrics["psnrs"])
    state = np.asarray(metrics["state_costs"])
    for i in range(recon.shape[0]):
        out.append(f"{prefix}_recon_cost{i}: {recon[i]}")
        out.append(f"{prefix}_psnr{i}: {psnr[i]}")
    for i in range(state.shape[0]):
        out.append(f"{prefix}_state_cost{i}: {state[i]}")
    out.append(f"{prefix}_psnr_all: {np.asarray(metrics['psnr_all'])}")
    out.append(f"{prefix}_loss: {np.asarray(metrics['loss'])}")
    return out


def epoch_stats(values: List[float]) -> List[float]:
    """[mean, std, min, max, median] — the reference's per-epoch aggregate
    rows (train_model.py:970-973)."""
    arr = np.asarray(values, np.float64)
    return [float(arr.mean()), float(arr.std()), float(arr.min()),
            float(arr.max()), float(np.median(arr))]
