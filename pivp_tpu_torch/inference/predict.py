"""Inference + rendering: predict the next frames from a checkpoint and
compose the ground-truth vs prediction contact sheet / GIF.

Counterpart of `pivp_tpu/inference/predict.py`. The data-map reader, the
run-dir convention, the frame resize and the contact sheet are numpy/PIL
copies of the JAX package's; `load_model`, `run_prediction` and
`predict_and_render` run the port's predictor, on the GPU unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import csv
import glob
import logging
import os
from typing import List

import numpy as np
import torch

from pivp_tpu_torch import config as config_mod
from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.utils import checkpoint as ckpt_lib
from pivp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def get_data_info(data_dir: str, data_index: int):
    """Load one sequence's arrays + bitmap glob from map.csv
    (predict_model.py:30-51).

    Returns (image [0,1] float, image_pred 0..255 float full-res,
    image_bitmap_pred glob, action, state)."""
    rows = []
    with open(os.path.join(data_dir, "map.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) <= 1:
        raise ValueError("No file map found")
    idx = int(data_index) + 1
    if idx > len(rows) - 1:
        raise ValueError(
            f"Data index {data_index} is out of range for available data")
    row = rows[idx]

    def load(col):
        return np.float32(np.load(os.path.join(data_dir, row[col])))

    image = load(2)
    if row[6]:
        # Full-res pred array. The dtype decides the value range: the ETL
        # writes uint8 bitmaps (0..255) while model arrays are float
        # [0, 1] — dispatching on dtype (not on observed max) keeps a
        # genuinely dark uint8 sequence from being misread as floats.
        raw = np.load(os.path.join(data_dir, row[6]))
        if np.issubdtype(raw.dtype, np.integer):
            image_pred = np.float32(raw)
        elif raw.max() > 1.5:
            # Float array already in 0..255 (e.g. reference-era ETL
            # saved the raw decode as float).
            image_pred = np.float32(raw)
        else:
            image_pred = np.float32(raw) * 255.0
    else:
        image_pred = image * 255.0
    image_bitmap_pred = row[5]
    action = load(3)
    state = load(4)
    return image, image_pred, image_bitmap_pred, action, state


def infer_model_type(model_dir: str) -> str:
    """`<date>-<time>-<TYPE>-<batch>` run-dir convention
    (predict_model.py:91-95; dir name built at train_model.py:806)."""
    parts = os.path.basename(os.path.normpath(model_dir)).split("-")
    if len(parts) != 4:
        raise ValueError(
            f"Model {model_dir} is not recognized, use model_type to "
            "describe the type")
    return parts[2]


def load_model(checkpoint_path: str, model_type: str, num_masks: int,
               context_frames: int, use_state: bool,
               schedsamp_k: float = -1.0, image_height: int = 64,
               image_width: int = 64, sequence_length: int = 10,
               reference_literal: bool = False, device="cuda"):
    """Rebuild config + params from a checkpoint npz (written by either
    package) onto `device`. `reference_literal=True` runs the forward
    with the Chainer reference's literal semantics
    (config.as_reference_literal)."""
    dev = resolve_device(device)
    cfg = ModelConfig(
        model_type=model_type, num_masks=num_masks,
        use_state=use_state, scheduled_sampling_k=schedsamp_k,
        context_frames=context_frames, sequence_length=sequence_length,
        image_height=image_height, image_width=image_width)
    if reference_literal:
        cfg = config_mod.as_reference_literal(cfg)
    template = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    params = ckpt_lib.load_npz_into(checkpoint_path, template)
    return cfg, predictor.map_params(lambda t: t.to(dev), params)


def resize_frames(frames: np.ndarray, height: int, width: int,
                  normalize: bool = True) -> np.ndarray:
    """(T, H0, W0, C) -> (T, height, width, C) float32, optionally /255
    (predict_model.py:118-123 used chainer F.resize_images = bilinear)."""
    from PIL import Image

    out = np.zeros((frames.shape[0], height, width, frames.shape[-1]),
                   np.float32)
    for i, frame in enumerate(frames):
        img = Image.fromarray(np.uint8(np.clip(frame, 0, 255)))
        img = img.resize((width, height), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32)
    if normalize:
        out /= 255.0
    return out


def run_prediction(cfg, params, images: np.ndarray, actions: np.ndarray,
                   states: np.ndarray, device="cuda") -> np.ndarray:
    """Autoregressive prediction of one sequence on `device`; returns
    (T-1, H, W, C) float32 frames."""
    dev = resolve_device(device)
    t = images.shape[0]
    params = predictor.map_params(lambda p: p.to(dev), params)
    imgs = torch.as_tensor(images, device=dev)[:, None]   # (T, 1, H, W, C)
    acts = torch.as_tensor(actions, device=dev).reshape(t, 1, -1)
    stas = torch.as_tensor(states, device=dev).reshape(t, 1, -1)
    out = predictor.predict(params, cfg, imgs, acts, stas)
    return out["gen_images"][:, 0].float().cpu().numpy()


def frames_to_uint8(frames: np.ndarray,
                    renormalize: bool = False) -> np.ndarray:
    """Convert [0,1] float frames to uint8. `renormalize=True` reproduces
    the reference's per-frame min/max rescale (predict_model.py:131-137)."""
    out = []
    for frame in frames:
        f = frame.astype(np.float32)
        if renormalize:
            f = f - f.min()
            rng = f.max()
            if rng > 0:
                f = f / rng
        else:
            f = np.clip(f, 0.0, 1.0)
        out.append((f * 255.0).astype(np.uint8))
    return np.stack(out)


def _text_tile(text: str, width: int, height: int):
    from PIL import Image, ImageDraw, ImageFont

    tile = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(tile)
    try:
        font = ImageFont.truetype("DejaVuSans.ttf", 18)
    except OSError:
        font = ImageFont.load_default()
    bbox = draw.textbbox((0, 0), text, font=font)
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    draw.text(((width - w) / 2, (height - h) / 2), text, fill="black",
              font=font)
    return tile


def render_contact_sheet(out_path: str, ground_truth_frames: List,
                         predicted_frames: List, time_step: int,
                         frame_width: int, frame_height: int,
                         make_gif: bool = True) -> str:
    """Compose the 2-row (GT / prediction) labeled sheet, with an animated
    column when `make_gif` (layout semantics of predict_model.py:140-246).

    ground_truth_frames / predicted_frames: lists of PIL images already at
    (frame_width, frame_height).
    Returns the written file path.
    """
    from PIL import Image

    label_h = 50
    total_w = frame_width * time_step + label_h
    if make_gif:
        total_w += frame_width
    total_h = frame_height * 2 + label_h

    sheet = Image.new("RGBA", (total_w, total_h), "white")

    labels = [f"Time = {i + 1}" for i in range(time_step)]
    if make_gif:
        labels.append("Animated sequence")
    for i, text in enumerate(labels):
        sheet.paste(_text_tile(text, frame_width, label_h),
                    (label_h + frame_width * i, 0))
    for i, text in enumerate(["Ground truth", "Prediction"]):
        tile = _text_tile(text, frame_height, label_h).rotate(90,
                                                              expand=1)
        sheet.paste(tile, (0, label_h + frame_height * i))

    for i, img in enumerate(ground_truth_frames[:time_step]):
        sheet.paste(img, (label_h + frame_width * i, label_h))
    for i, img in enumerate(predicted_frames[:time_step]):
        sheet.paste(img, (label_h + frame_width * i,
                          label_h + frame_height))

    if not make_gif:
        sheet.save(out_path)
        return out_path

    # Animated column: stills underneath, gif frames flip through the
    # ground truth then the prediction.
    gif_x = label_h + frame_width * time_step
    if ground_truth_frames:
        sheet.paste(ground_truth_frames[0], (gif_x, label_h))
    if predicted_frames:
        sheet.paste(predicted_frames[0], (gif_x, label_h + frame_height))
    gif_frames = []
    for img in ground_truth_frames:
        f = Image.new("RGB", (total_w, total_h), "white")
        f.paste(img, (gif_x, label_h))
        gif_frames.append(f)
    for img in predicted_frames:
        f = Image.new("RGB", (total_w, total_h), "white")
        f.paste(img, (gif_x, label_h + frame_height))
        gif_frames.append(f)
    sheet.save(out_path, save_all=True, append_images=gif_frames,
               transparency=0)
    return out_path


def predict_and_render(model_dir: str, model_name: str, data_index: int,
                       models_dir: str = "models",
                       data_dir: str = "data/processed/brain-robotics-data"
                                       "/push/push_testnovel",
                       time_step: int = 8, model_type: str = "",
                       schedsamp_k: float = -1.0, context_frames: int = 2,
                       use_state: bool = True, num_masks: int = 10,
                       image_height: int = 64, image_width: int = 64,
                       original_image_height: int = 512,
                       original_image_width: int = 640,
                       downscale_factor: float = 0.5, gif: bool = True,
                       renormalize: bool = False,
                       reference_literal: bool = False,
                       device="cuda") -> str:
    """Full predict pipeline on `device`; returns the output image
    path."""
    from PIL import Image

    path = os.path.join(models_dir, model_dir)
    ckpt = os.path.join(path, model_name)
    if not os.path.exists(ckpt):
        raise ValueError(f"Checkpoint {ckpt} does not exist")

    image, image_pred, image_bitmap_pred, action, state = get_data_info(
        data_dir, data_index)
    if not model_type:
        model_type = infer_model_type(model_dir)

    seq_len = image.shape[0]
    cfg, params = load_model(
        ckpt, model_type, num_masks, context_frames, use_state,
        schedsamp_k, image_height, image_width, seq_len,
        reference_literal=reference_literal, device=device)

    # Full-res (T, H0, W0, C) in 0..255 (get_data_info contract) -> model
    # resolution in [0, 1].
    frames = resize_frames(image_pred, image_height, image_width)

    action = action[:, 0] if action.ndim == 3 else action
    state = state[:, 0] if state.ndim == 3 else state
    gen = run_prediction(cfg, params, frames, action, state, device=device)
    gen_u8 = frames_to_uint8(gen, renormalize=renormalize)

    frame_w = int(original_image_width * downscale_factor)
    frame_h = int(original_image_height * downscale_factor)

    # Ground truth tiles from the stored bitmaps when available, else from
    # the full-res array.
    gt_imgs = []
    bitmap_paths = sorted(glob.glob(
        os.path.join(data_dir, image_bitmap_pred))) if image_bitmap_pred \
        else []
    if bitmap_paths:
        for p in bitmap_paths[:time_step]:
            img = Image.open(p).convert("RGB")
            gt_imgs.append(img.resize((frame_w, frame_h), Image.LANCZOS))
    else:
        src = image_pred
        for i in range(min(time_step, src.shape[0])):
            img = Image.fromarray(np.uint8(np.clip(src[i], 0, 255)))
            gt_imgs.append(img.resize((frame_w, frame_h), Image.LANCZOS))

    pred_imgs = []
    for i in range(min(time_step, gen_u8.shape[0])):
        img = Image.fromarray(gen_u8[i], "RGB")
        img = img.resize((original_image_width, original_image_height),
                         Image.LANCZOS)
        pred_imgs.append(img.resize((frame_w, frame_h), Image.LANCZOS))

    ext = "gif" if gif else "png"
    out_path = os.path.join(
        path, f"prediction-{time_step}-{model_name}.{ext}")
    return render_contact_sheet(out_path, gt_imgs, pred_imgs, time_step,
                                frame_w, frame_h, make_gif=gif)
