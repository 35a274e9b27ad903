"""Raw -> processed ETL: parse robot-push TFRecord shards, decode/crop/
resize frames, tensorize actions/states, and emit the processed-dataset
artifact contract (map.csv + per-sequence npy + optional PNG bitmaps).

The port's own copy of `pivp_tpu/data/make_dataset_cli.py`, with the
reference ETL's capabilities (make_dataset.py):
  * per-timestep keys `move/<i>/image/encoded` (JPEG),
    `move/<i>/commanded_pose/vec_pitch_yaw` (action, 5f),
    `move/<i>/endeffector/vec_pitch_yaw` (state, 5f) (48-56);
  * center-crop to the short side then ANTIALIAS resize to 64x64 and
    scale to float32/255 (69-71, 104-117);
  * artifacts: image_batch_j.npy (T,64,64,3 f32), action/state_batch_j.npy
    (T,1,5), full-res image_batch_pred_j.npy + PNG bitmaps, and the
    map.csv index (122-158).

The reference drives a TF1 session and pulls ONE record per shard file
(make_dataset.py:100-102). Here a streaming TFRecord/protobuf parser
(data/tfrecord.py, framed by the native scanner) replaces the TF graph,
and each sequence's decode, resize and writes run on a thread pool.
`--sequences_per_file 1` reproduces the reference's one record per
shard; 0 ingests every record. The outputs do not depend on the number
of workers: `pool.map` keeps the input order.

Usage: python -m pivp_tpu_torch.data.make_dataset_cli --data_dir <raw>
       --out_dir <processed>
"""

from __future__ import annotations

import csv
import glob
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import click
import numpy as np

from pivp_tpu_torch.data import native, tfrecord
from pivp_tpu_torch.utils import logging_utils

logger = logging.getLogger(__name__)


def decode_sequence(example: Dict, sequence_length: int,
                    state_action_dimension: int,
                    image_shape: Tuple[int, int, int]):
    """Extract (jpeg_bytes list, actions (T,5), states (T,5)) from one
    parsed example."""
    jpegs: List[bytes] = []
    actions = np.zeros((sequence_length, state_action_dimension),
                       np.float32)
    states = np.zeros((sequence_length, state_action_dimension),
                      np.float32)
    for i in range(sequence_length):
        img_key = f"move/{i}/image/encoded"
        act_key = f"move/{i}/commanded_pose/vec_pitch_yaw"
        sta_key = f"move/{i}/endeffector/vec_pitch_yaw"
        if img_key not in example:
            raise KeyError(f"missing {img_key}")
        jpegs.append(example[img_key][0])
        actions[i] = np.asarray(example[act_key],
                                np.float32)[:state_action_dimension]
        states[i] = np.asarray(example[sta_key],
                               np.float32)[:state_action_dimension]
    return jpegs, actions, states


def process_frames(jpegs: List[bytes], resize_hw: Tuple[int, int],
                   original_shape: Tuple[int, int, int]):
    """JPEG-decode, center-crop to square, ANTIALIAS-resize, /255.
    Returns (small (T,h,w,3) f32 in [0,1], full (T,H0,W0,3) uint8)."""
    from PIL import Image
    import io

    h0, w0, _ = original_shape
    crop = min(h0, w0)
    small_list, full_list = [], []
    for buf in jpegs:
        img = Image.open(io.BytesIO(buf)).convert("RGB")
        full_list.append(np.asarray(img, np.uint8))
        w, h = img.size
        left = (w - crop) // 2
        top = (h - crop) // 2
        cropped = img.crop((left, top, left + crop, top + crop))
        resized = cropped.resize((resize_hw[1], resize_hw[0]),
                                 Image.LANCZOS)
        small_list.append(np.asarray(resized, np.float32) / 255.0)
    return np.stack(small_list), np.stack(full_list)


def convert(data_dir: str, out_dir: str, sequence_length: int = 10,
            image_original_width: int = 640,
            image_original_height: int = 512,
            image_original_channel: int = 3,
            image_resize_width: int = 64, image_resize_height: int = 64,
            state_action_dimension: int = 5, create_img: bool = True,
            create_img_prediction: bool = True,
            sequences_per_file: int = 1, num_workers: int = 8) -> int:
    """Convert every tfrecord shard under data_dir. Returns the number of
    sequences written."""
    files = sorted(glob.glob(os.path.join(data_dir, "*")))
    files = [f for f in files if os.path.isfile(f)]
    if not files:
        logger.error("No files found in directory %s", data_dir)
        return 0
    os.makedirs(out_dir, exist_ok=True)

    original_shape = (image_original_height, image_original_width,
                      image_original_channel)
    resize_hw = (image_resize_height, image_resize_width)

    def sequences():
        for path in files:
            count = 0
            for example in tfrecord.iter_examples(path):
                yield example
                count += 1
                if sequences_per_file and count >= sequences_per_file:
                    break

    csv_ref = []

    def handle(args):
        # The whole per-sequence pipeline (decode, resize, npy and PNG
        # writes) runs on the pool: PNG deflate dominates the artifact
        # contract, and PIL releases the GIL while it compresses, so in
        # the consumer loop it would serialize the dominant stage.
        j, example = args
        from PIL import Image

        jpegs, actions, states = decode_sequence(
            example, sequence_length, state_action_dimension,
            original_shape)
        small, full = process_frames(jpegs, resize_hw, original_shape)

        np.save(os.path.join(out_dir, f"image_batch_{j}"), small)
        # (T, 1, 5) layout for actions/states, per the reference
        # artifact contract.
        np.save(os.path.join(out_dir, f"action_batch_{j}"),
                actions[:, None, :])
        np.save(os.path.join(out_dir, f"state_batch_{j}"),
                states[:, None, :])

        ref = [j]
        if create_img:
            for k in range(small.shape[0]):
                Image.fromarray(np.uint8(small[k] * 255)).save(
                    os.path.join(out_dir, f"image_batch_{j}_{k}.png"))
            ref.append(f"image_batch_{j}_*.png")
        else:
            ref.append("")
        ref += [f"image_batch_{j}.npy", f"action_batch_{j}.npy",
                f"state_batch_{j}.npy"]
        if create_img_prediction:
            np.save(os.path.join(out_dir, f"image_batch_pred_{j}"),
                    full)
            for k in range(full.shape[0]):
                Image.fromarray(full[k]).save(
                    os.path.join(out_dir,
                                 f"image_batch_pred_{j}_{k}.png"))
            ref += [f"image_batch_pred_{j}_*.png",
                    f"image_batch_pred_{j}.npy"]
        else:
            ref += ["", ""]
        return ref

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        # pool.map preserves input order, so map.csv rows stay
        # deterministic regardless of worker completion order.
        for ref in pool.map(handle, enumerate(sequences())):
            csv_ref.append(ref)
            if len(csv_ref) % 25 == 0:
                logger.info("Converted %d sequences", len(csv_ref))

    with open(os.path.join(out_dir, "map.csv"), "w", newline="") as f:
        writer = csv.writer(f, quoting=csv.QUOTE_ALL)
        writer.writerow(["id", "img_bitmap_path", "img_np_path",
                         "action_np_path", "state_np_path",
                         "img_bitmap_pred_path", "img_np_pred_path"])
        writer.writerows(csv_ref)
    logger.info("Wrote %d sequences + map.csv to %s (native TFRecord "
                "scanner calls: %d)", len(csv_ref), out_dir,
                native.index_records.calls)
    return len(csv_ref)


@click.command()
@click.option('--data_dir', type=click.Path(exists=True),
              default='data/raw/brain-robotics-data/push/push_train',
              help='Directory containing data.')
@click.option('--out_dir', type=click.Path(),
              default='data/processed/brain-robotics-data/push/push_train',
              help='Output directory of the converted data.')
@click.option('--sequence_length', type=click.INT, default=10,
              help='Sequence length, including context frames.')
@click.option('--image_original_width', type=click.INT, default=640)
@click.option('--image_original_height', type=click.INT, default=512)
@click.option('--image_original_channel', type=click.INT, default=3)
@click.option('--image_resize_width', type=click.INT, default=64)
@click.option('--image_resize_height', type=click.INT, default=64)
@click.option('--state_action_dimension', type=click.INT, default=5)
@click.option('--create_img', type=click.INT, default=1,
              help='Create the bitmap image along the numpy RGB values.')
@click.option('--create_img_prediction', type=click.INT, default=1,
              help='Create the bitmaps used in the prediction phase.')
@click.option('--sequences_per_file', type=click.INT, default=1,
              help='Records to ingest per shard (reference behavior: 1). '
                   '0 = all records.')
@click.option('--num_workers', type=click.INT, default=8,
              help='Decode/resize thread-pool size.')
def main(**kwargs):
    """Turn raw robot-push tfrecords into processed npy/PNG tensors."""
    logging_utils.setup_logging()
    logger.info('making final data set from raw data')
    convert(**{k: (bool(v) if k.startswith('create_') else v)
               for k, v in kwargs.items()})


if __name__ == '__main__':
    # The reference loads .env before its ETL runs (make_dataset.py:173):
    # the same contract, dependency-free (utils/dotenv.py).
    from pivp_tpu_torch.utils.dotenv import find_dotenv, load_dotenv

    load_dotenv(find_dotenv())
    main()
