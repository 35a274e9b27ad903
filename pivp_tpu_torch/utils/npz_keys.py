"""Checkpoint inspector: list the keys (and shapes) of an npz checkpoint.

The port's own copy of `pivp_tpu/utils/npz_keys.py`: each array's key,
shape and dtype, then the count of arrays and of parameters. Works on
the packages' flat checkpoints and on Chainer-layout exports alike.

Usage: python -m pivp_tpu_torch.utils.npz_keys CHECKPOINT.npz
"""

from __future__ import annotations

import sys

import numpy as np


def describe(path: str) -> str:
    lines = []
    total = 0
    with np.load(path) as data:
        for key in sorted(data.keys()):
            arr = data[key]
            total += arr.size
            lines.append(f"{key}  {arr.shape}  {arr.dtype}")
    lines.append(f"-- {len(lines)} arrays, {total:,} parameters")
    return "\n".join(lines)


def main() -> None:
    if len(sys.argv) != 2:
        print(__doc__)
        raise SystemExit(1)
    try:
        print(describe(sys.argv[1]))
    except BrokenPipeError:  # piped into head/less
        pass


if __name__ == "__main__":
    main()
