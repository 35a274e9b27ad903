"""Fused K-dispatch batch assembly for the training input pipeline.

Counterpart of `pivp_tpu/data/assembler.py`. The training loop dispatches
K optimizer steps at a time (TrainConfig.steps_per_call), so its
producer assembles K batches per dispatch: gather the shuffled
sequences, transpose them to time-major, and quantize the frames to
uint8 for the transfer. With numpy that is ~4 passes over the payload
(gather, swapaxes + ascontiguousarray, np.stack, quantize);
`assemble_calls` does it in one pass through the native routine
(csrc/batch_assembler.cc, data/native.assemble) whenever the image
store is a C-contiguous float32 ndarray. A lazy or memory-mapped store,
or any other array, takes the numpy path, as in the JAX design; a host
whose compiler fails raises instead (data/native.py). The numpy path is
also the native routine's plain version: the two are bit-identical.

Collation contract: concat_examples' time-major stacking
(train_model.py:51-71), K-stacked.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pivp_tpu_torch.data import native

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _time_major_gather(src, idx: np.ndarray) -> np.ndarray:
    """src[(K,B) idx] -> (K, T, B, ...), contiguous. Works for ndarrays
    and for LazySequences-style stores (1-D integer gather only)."""
    k, b = idx.shape
    g = np.asarray(src[idx.reshape(-1)])          # (K*B, T, ...)
    g = g.reshape(k, b, *g.shape[1:])
    return np.ascontiguousarray(np.swapaxes(g, 1, 2))


def quantize_images(images: np.ndarray) -> np.ndarray:
    """[0,1] float frames -> uint8 for the host->device transfer
    (dequantized on the device in the rollout); the rounding and
    clipping of ops/transforms.quantize_frames_u8, which the native
    routine matches bit for bit: clip(x*255+0.5, 0, 255) in float32,
    then truncate to uint8. The training and validation payloads both
    take it."""
    return np.clip(images * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def native_ok(images) -> bool:
    """Whether `assemble_calls` gathers these images natively: a
    C-contiguous float32 ndarray (what data/native.assemble takes)."""
    return (isinstance(images, np.ndarray)
            and images.dtype == np.float32
            and images.flags["C_CONTIGUOUS"]
            and images.ndim >= 3)


def assemble_calls_plain(arrays: Arrays, idx: np.ndarray,
                         quantize: bool) -> Arrays:
    """The numpy version of `assemble_calls` (same outputs)."""
    images, actions, states = arrays
    imgs = _time_major_gather(images, idx)
    if quantize:
        imgs = quantize_images(imgs)
    return (imgs, _time_major_gather(actions, idx),
            _time_major_gather(states, idx))


def assemble_calls(arrays: Arrays, idx: np.ndarray,
                   quantize: bool) -> Arrays:
    """Assemble a K-step dispatch payload from sequence indices.

    arrays: (images (N,T,H,W,C) f32 | lazy store, actions (N,T,A),
    states (N,T,S)); idx: (K, B) int64 sequence indices.
    Returns (images (K,T,B,H,W,C) u8-if-quantize-else-f32,
    actions (K,T,B,A) f32, states (K,T,B,S) f32): the payload that
    gathering each batch and stacking them with numpy produces, bit for
    bit."""
    images, actions, states = arrays
    if not native_ok(images):
        return assemble_calls_plain(arrays, idx, quantize)
    return (native.assemble(images, idx, quantize),
            _time_major_gather(actions, idx),
            _time_major_gather(states, idx))
