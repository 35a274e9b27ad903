"""Configuration of the PyTorch port of the video predictor.

The port's own copy of `pivp_tpu/config.py`'s `ModelConfig`: the fields
that change values keep their names and meaning, so a reader can hold
one against the other. Left out are the TPU lowering knobs
(`pad_gate_convs`, `one_by_one_matmul`, `enc0_space_to_depth`,
`scan_unroll`, `pallas_interpret`), which rewrite the same math without
changing its values, and the TPU backend probe.

The two kernel switches take the place of the JAX `use_pallas` /
`use_pallas_gates` fields: `use_kernel` routes the per-pixel tap
application of the fused CDNA composite through the hand-written CUDA
kernels (ops/kernels/local_apply.py), `use_kernel_gates` the ConvLSTM gate
update (ops/kernels/lstm_gates.py), forward and backward. Both are on by
default. On a CPU tensor a kernel wrapper computes its plain PyTorch
version instead.

`TrainConfig` is the port's copy of the JAX package's training-loop
configuration, without its TPU, mesh and multi-host fields.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Lower bound used when normalizing predicted kernels.
RELU_SHIFT = 1e-12

# Kernel size of the DNA and CDNA transformation heads.
DNA_KERN_SIZE = 5

# The switches that together reproduce the Chainer reference
# implementation's literal runtime semantics (see ModelConfig).
REFERENCE_LITERAL_OVERRIDES = dict(
    stp_shared_params=True,
    detach_sampled=True,
    chainer_mask_scramble=True,
    dna_border_zero=True,
)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def as_reference_literal(cfg: "ModelConfig") -> "ModelConfig":
    """Return `cfg` with every reference-quirk switch set to the Chainer
    implementation's literal behavior (mask-softmax scramble, DNA border
    zeroing, detached scheduled sampling, shared STP params)."""
    return dataclasses.replace(cfg, **REFERENCE_LITERAL_OVERRIDES)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture + rollout configuration (field meanings as in
    the JAX package's ModelConfig)."""

    model_type: str = "CDNA"  # one of CDNA | DNA | STP
    num_masks: int = 10
    use_state: bool = True
    # k of inverse-sigmoid scheduled sampling; -1 disables it.
    scheduled_sampling_k: float = 900.0
    context_frames: int = 2
    sequence_length: int = 10

    image_height: int = 64
    image_width: int = 64
    color_channels: int = 3
    action_dim: int = 5
    state_dim: int = 5

    dna_kern_size: int = DNA_KERN_SIZE
    relu_shift: float = RELU_SHIFT

    # ConvLSTM forget-gate bias added before the sigmoid.
    forget_bias: float = 1.0
    layer_norm_eps: float = 1e-6

    # Reference-quirk switches (see as_reference_literal).
    stp_shared_params: bool = True
    detach_sampled: bool = False
    chainer_mask_scramble: bool = False
    dna_border_zero: bool = False

    # Compute dtype of convolutions and matmuls; params are stored f32.
    compute_dtype: str = "float32"
    # Precision of the plain ConvLSTM gate math: 'float32' or 'compute'.
    # The gate kernel always computes in f32 (f64 on the CPU path when
    # the carry is f64).
    lstm_gate_compute: str = "float32"

    # Collapse the masked CDNA mixture into one per-pixel kernel.
    fused_cdna: bool = True
    # Run the masks conv and the head's enc7 conv as one conv.
    merge_output_convs: bool = True
    # Hand-written CUDA kernels (the JAX use_pallas / use_pallas_gates).
    use_kernel: bool = True
    use_kernel_gates: bool = True

    state_cost_weight: float = 1e-4

    enc_channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 96, 64)
    lstm_channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 64, 32)

    def __post_init__(self):
        if self.model_type not in ("CDNA", "DNA", "STP"):
            raise ValueError(f"No network specified: {self.model_type!r}")
        if self.model_type == "DNA" and self.num_masks != 1:
            raise ValueError("Only one mask is supported for DNA model.")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be float32/bfloat16/float16/float64, "
                f"got {self.compute_dtype!r}")
        if self.lstm_gate_compute not in ("float32", "compute"):
            raise ValueError(
                f"lstm_gate_compute must be float32/compute, got "
                f"{self.lstm_gate_compute!r}")
        if self.context_frames < 1:
            raise ValueError("context_frames must be >= 1")
        if self.sequence_length <= self.context_frames:
            raise ValueError("sequence_length must exceed context_frames")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def is_cdna(self) -> bool:
        return self.model_type == "CDNA"

    @property
    def is_dna(self) -> bool:
        return self.model_type == "DNA"

    @property
    def is_stp(self) -> bool:
        return self.model_type == "STP"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration: the reference CLI's 19 flags (field
    meanings as in the JAX package's TrainConfig) and the JAX package's
    extras. Left out are the TPU lowering fields (`pad_gate_convs`,
    `scan_unroll`, `use_pallas`): `use_kernel` / `use_kernel_gates` take
    `use_pallas`'s place. `num_devices` and `spatial_parallel` map onto
    a torch.distributed process group (parallel/mesh.py)."""

    data_dir: str = "data/processed/brain-robotics-data/push/push_train"
    output_dir: str = "models"
    event_log_dir: str = "models"
    num_iterations: int = 100000
    pretrained_model: str = ""
    pretrained_state: str = ""
    sequence_length: int = 10
    context_frames: int = 2
    use_state: bool = True
    model_type: str = "CDNA"
    num_masks: int = 10
    schedsamp_k: float = 900.0
    train_val_split: float = 0.95
    batch_size: int = 32
    learning_rate: float = 1e-3
    validation_interval: int = 200
    save_interval: int = 50
    debug: bool = False

    seed: int = 0
    image_height: int = 64
    image_width: int = 64
    # 'auto' resolves to float32 (as does lstm_gate_compute='auto'):
    # whether bf16 keeps the port within its tolerances on the card is
    # not settled.
    compute_dtype: str = "auto"
    lstm_gate_compute: str = "auto"
    # torch.utils.checkpoint around each timestep (memory for FLOPs).
    remat: bool = False
    use_kernel: bool = True
    use_kernel_gates: bool = True
    fused_cdna: bool = True
    merge_output_convs: bool = True
    # Exact-mean gradient accumulation over this many microbatches.
    grad_accum: int = 1
    # Abort + save an emergency checkpoint if the loss goes non-finite.
    nan_guard: bool = True
    # Ship image batches to the device as uint8, dequantize there.
    u8_transfer: bool = True
    reference_literal: bool = False
    # Extra ModelConfig field overrides applied last in model_config().
    model_overrides: Tuple[Tuple[str, object], ...] = ()
    # Torch device of the run: "cuda" (default) or "cpu".
    device: str = "cuda"
    # Optimizer steps per dispatch: 0 = auto (1), K > 1 = K steps per
    # dispatch, on a GPU as replays of a CUDA graph of the train step.
    steps_per_call: int = 0
    # Input-pipeline prefetch depth: a daemon thread assembles (and, on
    # a GPU, pins) the next dispatches' inputs. 0 = on the main thread.
    prefetch: int = 2
    # Read sequences from disk per batch instead of loading the whole
    # data set into RAM.
    lazy_load: bool = False
    # "npz" (the reference artifact contract) or "torch": also a
    # full-state checkpoint, atomically written, that a run started
    # again with the same run name resumes from.
    checkpointer: str = "npz"
    # SIGTERM/SIGINT checkpoint at the next dispatch boundary and return.
    graceful_preemption: bool = True
    # Data-parallel ranks: 0 = every rank of the process group (one
    # process per GPU); N > 0 must be the world size.
    num_devices: int = 0
    # Spatial (image-height) parallel ways: only 1, not ported yet.
    spatial_parallel: int = 1

    def __post_init__(self):
        if self.checkpointer not in ("npz", "torch"):
            raise ValueError(f"checkpointer must be npz or torch, got "
                             f"{self.checkpointer!r}")
        if self.steps_per_call < 0:
            raise ValueError("steps_per_call must be >= 0")

    def model_config(self) -> ModelConfig:
        dtype = ("float32" if self.compute_dtype == "auto"
                 else self.compute_dtype)
        gate = ("float32" if self.lstm_gate_compute == "auto"
                else self.lstm_gate_compute)
        quirks = (REFERENCE_LITERAL_OVERRIDES if self.reference_literal
                  else {})
        mc = ModelConfig(
            model_type=self.model_type,
            num_masks=self.num_masks,
            use_state=self.use_state,
            scheduled_sampling_k=self.schedsamp_k,
            context_frames=self.context_frames,
            sequence_length=self.sequence_length,
            image_height=self.image_height,
            image_width=self.image_width,
            compute_dtype=dtype,
            lstm_gate_compute=gate,
            use_kernel=self.use_kernel,
            use_kernel_gates=self.use_kernel_gates,
            fused_cdna=self.fused_cdna,
            merge_output_convs=self.merge_output_convs,
            **quirks,
        )
        if self.model_overrides:
            mc = dataclasses.replace(mc, **dict(self.model_overrides))
        return mc
