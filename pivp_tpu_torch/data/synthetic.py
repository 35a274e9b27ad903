"""Synthetic robot-push-like sequences for smoke runs and tests.

The port's own copy of `pivp_tpu/data/synthetic.py` (numpy only), so the
port makes a processed data directory from a seed without importing the
JAX package: action-conditioned moving-square sequences with the tensor
contract of the processed dataset (images (T, H, W, C) float32 in
[0, 1]; actions/states (T, 5)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_sequences(num_sequences: int, sequence_length: int = 10,
                       height: int = 64, width: int = 64, channels: int = 3,
                       state_dim: int = 5, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (images (N, T, H, W, C), actions (N, T, 5), states (N, T, 5)).

    Each sequence has two colored squares; one is "pushed" with a velocity
    encoded in the action vector, the other drifts. The state integrates
    the action (end-effector-like), so the state-prediction head has
    learnable signal.
    """
    rng = np.random.RandomState(seed)
    images = np.zeros((num_sequences, sequence_length, height, width,
                       channels), np.float32)
    actions = np.zeros((num_sequences, sequence_length, state_dim),
                       np.float32)
    states = np.zeros((num_sequences, sequence_length, state_dim),
                      np.float32)

    size = max(4, height // 8)
    for n in range(num_sequences):
        pos = rng.uniform(size, [height - 2 * size, width - 2 * size],
                          size=(2, 2))
        vel = rng.uniform(-2.0, 2.0, size=(2, 2))
        color = rng.uniform(0.3, 1.0, size=(2, channels))
        bg = rng.uniform(0.0, 0.15)
        state = rng.uniform(-0.5, 0.5, size=(state_dim,))
        for t in range(sequence_length):
            frame = np.full((height, width, channels), bg, np.float32)
            for obj in range(2):
                y, x = pos[obj]
                y0, x0 = int(round(y)), int(round(x))
                y0 = np.clip(y0, 0, height - size)
                x0 = np.clip(x0, 0, width - size)
                frame[y0:y0 + size, x0:x0 + size] = color[obj]
            images[n, t] = frame
            act = np.concatenate([vel[0] / 2.0,
                                  rng.uniform(-0.05, 0.05, state_dim - 2)])
            actions[n, t] = act
            states[n, t] = state
            # Integrate: the "pushed" object follows the action.
            state = state + 0.1 * act
            pos = pos + vel
            # Bounce off walls.
            for obj in range(2):
                for d, lim in ((0, height - size), (1, width - size)):
                    if pos[obj, d] < 0 or pos[obj, d] > lim:
                        vel[obj, d] = -vel[obj, d]
                        pos[obj, d] = np.clip(pos[obj, d], 0, lim)
    return images, actions, states


def write_processed_dir(out_dir: str, num_sequences: int = 8,
                        sequence_length: int = 10, height: int = 64,
                        width: int = 64, seed: int = 0) -> None:
    """Write synthetic sequences in the processed-dataset layout (map.csv +
    per-sequence npy files; contract of make_dataset.py:122-158) so the
    training CLI can point at it directly."""
    import csv
    import os

    os.makedirs(out_dir, exist_ok=True)
    images, actions, states = generate_sequences(
        num_sequences, sequence_length, height, width, seed=seed)
    rows = []
    for j in range(num_sequences):
        np.save(os.path.join(out_dir, f"image_batch_{j}.npy"), images[j])
        # Reference stores actions/states as (T, 1, 5)
        # (make_dataset.py:78-81 reshape + np.save at 131-132).
        np.save(os.path.join(out_dir, f"action_batch_{j}.npy"),
                actions[j][:, None, :])
        np.save(os.path.join(out_dir, f"state_batch_{j}.npy"),
                states[j][:, None, :])
        rows.append([j, "", f"image_batch_{j}.npy", f"action_batch_{j}.npy",
                     f"state_batch_{j}.npy", "", ""])
    with open(os.path.join(out_dir, "map.csv"), "w", newline="") as f:
        writer = csv.writer(f, quoting=csv.QUOTE_ALL)
        writer.writerow(["id", "img_bitmap_path", "img_np_path",
                         "action_np_path", "state_np_path",
                         "img_bitmap_pred_path", "img_np_pred_path"])
        writer.writerows(rows)
