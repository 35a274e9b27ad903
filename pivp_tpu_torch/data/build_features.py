"""Feature-engineering stage over the processed dataset.

The port's own copy of `pivp_tpu/data/build_features.py`. The reference
ships an empty cookiecutter stub here (features/build_features.py);
this stage computes per-dataset statistics for normalization,
diagnostics and data validation, once, into `features.json` beside
map.csv.

Usage: python -m pivp_tpu_torch.data.build_features --data_dir <processed>
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

import click
import numpy as np

from pivp_tpu_torch.utils import logging_utils

logger = logging.getLogger(__name__)


def compute_statistics(data_dir: str) -> Dict[str, object]:
    from pivp_tpu_torch.data import dataset

    images, actions, states = dataset.load_sequences(data_dir)
    per_frame_motion = np.abs(np.diff(images, axis=1)).mean(
        axis=(2, 3, 4))  # (N, T-1)
    stats = {
        "num_sequences": int(images.shape[0]),
        "sequence_length": int(images.shape[1]),
        "image_shape": list(images.shape[2:]),
        "image_mean": [float(x) for x in images.mean(axis=(0, 1, 2, 3))],
        "image_std": [float(x) for x in images.std(axis=(0, 1, 2, 3))],
        "action_mean": [float(x) for x in actions.mean(axis=(0, 1))],
        "action_std": [float(x) for x in actions.std(axis=(0, 1))],
        "state_mean": [float(x) for x in states.mean(axis=(0, 1))],
        "state_std": [float(x) for x in states.std(axis=(0, 1))],
        "mean_interframe_motion": float(per_frame_motion.mean()),
        "static_sequences": int((per_frame_motion.mean(axis=1)
                                 < 1e-5).sum()),
    }
    return stats


@click.command()
@click.option('--data_dir', type=click.Path(exists=True), required=True,
              help='Processed dataset directory (contains map.csv).')
@click.option('--out_file', type=click.Path(), default='',
              help='Output JSON (default: <data_dir>/features.json).')
def main(data_dir, out_file):
    """Compute dataset statistics into features.json."""
    logging_utils.setup_logging()
    stats = compute_statistics(data_dir)
    out_file = out_file or os.path.join(data_dir, "features.json")
    with open(out_file, "w") as f:
        json.dump(stats, f, indent=2)
    logger.info("Wrote %s", out_file)


if __name__ == '__main__':
    main()
