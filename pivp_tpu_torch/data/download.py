"""Robot-push dataset downloader.

The port's own copy of `pivp_tpu/data/download.py`: the reference's
data/raw/download_data.sh (curl of 274 tfrecord shards from the public
brain-robotics-data GCS bucket) as a Python CLI. The shard listing is
generated: 264 push_train shards plus 5 push_testnovel and 5
push_testseen shards (the contents of the reference's
push_datafiles.txt).

Usage: python -m pivp_tpu_torch.data.download --out_dir <raw> [--split S]
"""

from __future__ import annotations

import logging
import os
import urllib.request
from typing import List, Optional

import click

from pivp_tpu_torch.utils import logging_utils

logger = logging.getLogger(__name__)

BUCKET = "https://storage.googleapis.com/brain-robotics-data"

SPLITS = {
    "push_train": 264,
    "push_testnovel": 5,
    "push_testseen": 5,
}


def shard_listing(splits: Optional[List[str]] = None) -> List[str]:
    """Relative shard paths, e.g.
    push/push_train/push_train.tfrecord-00000-of-00264."""
    out = []
    for split in (splits or SPLITS):
        n = SPLITS[split]
        for i in range(n):
            out.append(
                f"push/{split}/{split}.tfrecord-{i:05d}-of-{n:05d}")
    return out


def download_file(rel_path: str, out_dir: str,
                  skip_existing: bool = True) -> str:
    url = f"{BUCKET}/{rel_path}"
    out_path = os.path.join(out_dir, rel_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    if skip_existing and os.path.exists(out_path) and \
            os.path.getsize(out_path) > 0:
        return out_path
    logger.info("Downloading %s", url)
    urllib.request.urlretrieve(url, out_path)
    return out_path


@click.command()
@click.option('--out_dir', type=click.Path(),
              default='data/raw/brain-robotics-data',
              help='Directory to download into.')
@click.option('--split', type=click.STRING, default='',
              help='Limit to one split: push_train / push_testnovel / '
                   'push_testseen.')
@click.option('--listing', type=click.Path(), default='',
              help='Optional file of shard paths (one per line) to use '
                   'instead of the generated listing.')
@click.option('--limit', type=click.INT, default=0,
              help='Download at most N shards (0 = all).')
def main(out_dir, split, listing, limit):
    """Download the Google Brain robot-push tfrecord shards."""
    logging_utils.setup_logging()
    if listing:
        with open(listing) as f:
            paths = [line.strip() for line in f if line.strip()]
    else:
        paths = shard_listing([split] if split else None)
    if limit:
        paths = paths[:limit]
    for p in paths:
        try:
            download_file(p, out_dir)
        except Exception as exc:  # noqa: BLE001 — log and continue
            logger.error("Failed %s: %s", p, exc)
    logger.info("Done: %d shards", len(paths))


if __name__ == '__main__':
    main()
