"""Action/state-conditioned ConvLSTM video predictor (CDNA / DNA / STP).

Counterpart of `pivp_tpu/models/predictor.py`: the 7-stage trunk (convs,
ConvLSTMs, flattened LayerNorms, state/action smear, skip connections),
the transformation head (models/heads.py) and the mask compositor, run
as a Python loop over timesteps: the feed-self rollout (`train=False`,
the predict and serving path) and the scheduled-sampling rollout of
training (`train=True`). CDNA takes the fused composite when
`fused_cdna` is on; the other heads, and CDNA with it off, composite
their candidate stack.

Parameters are a nested dict of tensors with the JAX package's keys and
PyTorch's weight layouts (ops/layers.py); utils/weights.py maps them
from and to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.models import heads
from pivp_tpu_torch.ops import convlstm, layers, metrics, sampling, transforms
from pivp_tpu_torch.ops.kernels import local_apply
from pivp_tpu_torch.utils.device import resolve_device, to_device

Params = Dict[str, Any]


def _resolutions(cfg: ModelConfig) -> Tuple[Tuple[int, int], ...]:
    h, w = cfg.image_height, cfg.image_width
    return ((h, w), (h // 2, w // 2), (h // 4, w // 4), (h // 8, w // 8))


def hidden5_dim(cfg: ModelConfig) -> int:
    _, _, _, (h8, w8) = _resolutions(cfg)
    return h8 * w8 * cfg.lstm_channels[4]


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Build the parameter dict (float32, Glorot-uniform weights drawn
    from `generator` on the CPU, then moved to `device`)."""
    dev = resolve_device(device)
    g = generator
    (r0, r1, r2, r3) = _resolutions(cfg)
    ec = cfg.enc_channels
    lc = cfg.lstm_channels
    c = cfg.color_channels
    sa_dim = cfg.action_dim + cfg.state_dim
    enc3_in = ec[2] + (sa_dim if cfg.use_state else 0)

    params: Params = {
        "enc0": layers.conv2d_init(g, c, ec[0], 5),
        "enc1": layers.conv2d_init(g, lc[1], ec[1], 3),
        "enc2": layers.conv2d_init(g, lc[3], ec[2], 3),
        "enc3": layers.conv2d_init(g, enc3_in, ec[3], 1),
        "enc4": layers.deconv2d_init(g, lc[4], ec[4], 3),
        "enc5": layers.deconv2d_init(g, lc[5] + ec[1], ec[5], 3),
        "enc6": layers.deconv2d_init(g, lc[6] + ec[0], ec[6], 3),
        "lstm1": convlstm.conv_lstm_init(g, ec[0], lc[0]),
        "lstm2": convlstm.conv_lstm_init(g, lc[0], lc[1]),
        "lstm3": convlstm.conv_lstm_init(g, ec[1], lc[2]),
        "lstm4": convlstm.conv_lstm_init(g, lc[2], lc[3]),
        "lstm5": convlstm.conv_lstm_init(g, ec[3], lc[4]),
        "lstm6": convlstm.conv_lstm_init(g, ec[4], lc[5]),
        "lstm7": convlstm.conv_lstm_init(g, ec[5], lc[6]),
        "norm_enc0": layers.layer_norm_flat_init((*r1, ec[0])),
        "norm_enc6": layers.layer_norm_flat_init((*r0, ec[6])),
        "hidden1": layers.layer_norm_flat_init((*r1, lc[0])),
        "hidden2": layers.layer_norm_flat_init((*r1, lc[1])),
        "hidden3": layers.layer_norm_flat_init((*r2, lc[2])),
        "hidden4": layers.layer_norm_flat_init((*r2, lc[3])),
        "hidden5": layers.layer_norm_flat_init((*r3, lc[4])),
        "hidden6": layers.layer_norm_flat_init((*r2, lc[5])),
        "hidden7": layers.layer_norm_flat_init((*r1, lc[6])),
        "masks": layers.deconv2d_init(g, ec[6], cfg.num_masks + 1, 1),
        "state_pred": layers.dense_init(g, sa_dim, cfg.state_dim),
    }
    head_init, _ = heads.HEADS[cfg.model_type]
    params["head"] = head_init(g, cfg, hidden5_dim(cfg))
    return map_params(lambda t: t.to(dev), params)


def map_params(fn, params: Params) -> Params:
    """Apply `fn` to every tensor of a nested parameter dict."""
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def init_lstm_states(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    (r0, r1, r2, r3) = _resolutions(cfg)
    res = (r1, r1, r2, r2, r3, r2, r1)
    return tuple(
        convlstm.zero_state(batch, rh, rw, ch, dtype, device)
        for (rh, rw), ch in zip(res, cfg.lstm_channels))


class StepOutput(NamedTuple):
    gen_image: torch.Tensor                     # (B, H, W, C)
    gen_state: torch.Tensor                     # (B, state_dim)
    # (enc0, ..., enc6, enc7) with `capture`, else None.
    encs: Optional[Tuple[torch.Tensor, ...]] = None


def forward_step(params: Params, cfg: ModelConfig, lstm_states,
                 prev_image: torch.Tensor, state_action: torch.Tensor,
                 capture: bool = False):
    """Run the trunk + head + compositor for one timestep. `capture`
    also returns the stage activations enc0..enc7 (enc7 is the head's:
    relu of its deconv for CDNA and DNA, the raw deconv for STP)."""
    relu = torch.relu
    fb = cfg.forget_bias
    gd = torch.float32 if cfg.lstm_gate_compute == "float32" else cfg.dtype

    def cell(p, st, inp):
        return convlstm.conv_lstm(p, st, inp, fb, gd,
                                  use_kernel=cfg.use_kernel_gates)
    eps = cfg.layer_norm_eps
    s1, s2, s3, s4, s5, s6, s7 = lstm_states

    # Stage 0: enc0 conv 5x5 s2 + LayerNorm.
    x = layers.conv2d(params["enc0"], prev_image, stride=2)
    enc0 = relu(layers.layer_norm_flat(params["norm_enc0"], x, eps))

    # Stage 1: lstm1 -> LN -> lstm2 -> LN -> enc1 conv 3x3 s2.
    s1, h = cell(params["lstm1"], s1, enc0)
    h1 = layers.layer_norm_flat(params["hidden1"], h, eps)
    s2, h = cell(params["lstm2"], s2, h1)
    h2 = layers.layer_norm_flat(params["hidden2"], h, eps)
    enc1 = relu(layers.conv2d(params["enc1"], h2, stride=2))

    # Stage 2: lstm3 -> LN -> lstm4 -> LN -> enc2 conv 3x3 s2.
    s3, h = cell(params["lstm3"], s3, enc1)
    h3 = layers.layer_norm_flat(params["hidden3"], h, eps)
    s4, h = cell(params["lstm4"], s4, h3)
    h4 = layers.layer_norm_flat(params["hidden4"], h, eps)
    enc2 = relu(layers.conv2d(params["enc2"], h4, stride=2))

    # Stage 3: smear state/action over space, concat, enc3 conv 1x1.
    x = enc2
    if cfg.use_state:
        b, hh, ww, _ = x.shape
        smear = state_action[:, None, None, :].to(x.dtype).expand(
            b, hh, ww, state_action.shape[-1])
        x = torch.cat([x, smear], dim=-1)
    enc3 = relu(layers.conv2d(params["enc3"], x, stride=1, padding=0))

    # Stage 4: lstm5 -> LN(hidden5) -> enc4 deconv up to H/4.
    s5, h = cell(params["lstm5"], s5, enc3)
    h5 = layers.layer_norm_flat(params["hidden5"], h, eps)
    (r0, r1, r2, _) = _resolutions(cfg)
    enc4 = relu(layers.deconv2d(params["enc4"], h5, stride=2, padding=1,
                                outsize=r2))

    # Stage 5: lstm6 -> LN -> skip(enc1) -> enc5 deconv up to H/2.
    s6, h = cell(params["lstm6"], s6, enc4)
    h6 = layers.layer_norm_flat(params["hidden6"], h, eps)
    x = torch.cat([h6, enc1], dim=-1)
    enc5 = relu(layers.deconv2d(params["enc5"], x, stride=2, padding=1,
                                outsize=r1))

    # Stage 6: lstm7 -> LN -> skip(enc0) -> enc6 deconv up to H + LN.
    s7, h = cell(params["lstm7"], s7, enc5)
    h7 = layers.layer_norm_flat(params["hidden7"], h, eps)
    x = torch.cat([h7, enc0], dim=-1)
    x = layers.deconv2d(params["enc6"], x, stride=2, padding=1, outsize=r0)
    enc6 = relu(layers.layer_norm_flat(params["norm_enc6"], x, eps))

    # Head + masks + composite. With merge_output_convs the masks deconv
    # and the head's enc7 deconv (both 1x1 on enc6) run as one conv over
    # concatenated output channels, split afterwards.
    enc7_raw = None
    if cfg.merge_output_convs:
        mw, hw = params["masks"], params["head"]["enc7"]
        merged = {"w": torch.cat([mw["w"], hw["w"]], dim=1),
                  "b": torch.cat([mw["b"], hw["b"]])}
        out = layers.deconv2d(merged, enc6, stride=1, padding=0)
        n_mask = cfg.num_masks + 1
        mask_logits = out[..., :n_mask]
        enc7_raw = out[..., n_mask:]
    else:
        mask_logits = layers.deconv2d(params["masks"], enc6, stride=1,
                                      padding=0)
    if cfg.is_cdna and cfg.fused_cdna:
        synth, kerns, enc7 = heads.cdna_head_parts(
            params["head"], cfg, enc6, h5, enc7_raw)
        local = local_apply.local_kernel_apply if cfg.use_kernel else None
        gen_image = transforms.fused_cdna_composite(
            prev_image, synth, kerns, mask_logits, local_apply=local,
            scramble=cfg.chainer_mask_scramble)
    else:
        # The candidate stack; the compositor keeps the first num_masks.
        _, head_fn = heads.HEADS[cfg.model_type]
        candidates, enc7 = head_fn(params["head"], cfg, enc6, h5,
                                   prev_image, enc7_raw)
        gen_image, _ = transforms.mask_composite(
            prev_image, candidates[:, :cfg.num_masks], mask_logits,
            scramble=cfg.chainer_mask_scramble)

    # State predictor fed back each step.
    gen_state = layers.dense(
        params["state_pred"],
        state_action.to(torch.promote_types(state_action.dtype,
                                            torch.float32)))

    new_states = (s1, s2, s3, s4, s5, s6, s7)
    encs = ((enc0, enc1, enc2, enc3, enc4, enc5, enc6, enc7) if capture
            else None)
    return new_states, StepOutput(gen_image, gen_state, encs)


def rollout_frames(params: Params, cfg: ModelConfig, images: torch.Tensor,
                   actions: torch.Tensor, states: torch.Tensor, *,
                   n_ground_truth: int = 0,
                   uniforms: Optional[torch.Tensor] = None,
                   remat: bool = False, capture: bool = False):
    """The prediction loop: ground truth for the first context_frames
    steps, then the model's own predictions, or, with `uniforms`
    ((T-1, B), one row per step), a scheduled-sampling mix of exactly
    `n_ground_truth` ground-truth rows with the generated ones.

    images: (T, B, H, W, C) float in [0, 1] (or uint8), time-major;
    actions/states: (T, B, 5). `remat` recomputes each step's
    activations in the backward (torch.utils.checkpoint). Returns
    (gen_images (T-1, B, H, W, C) in the compute dtype, gen_states
    (T-1, B, S)), and with `capture` a third element: the stage
    activations enc0..enc7, each stacked over the steps (T-1, B, ...)."""
    batch = images.shape[1]
    dtype = cfg.dtype
    sdt = torch.promote_types(torch.float32, dtype)
    if not images.is_floating_point():
        images = images.to(torch.float32) / 255.0
    images_c = images.to(dtype)
    if dtype != torch.float32:
        params = map_params(
            lambda p: p.to(dtype) if p.dtype == torch.float32 else p,
            params)

    def step(*args):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                forward_step, *args, capture=capture, use_reentrant=False)
        return forward_step(*args, capture=capture)

    lstm_states = init_lstm_states(cfg, batch, dtype, images.device)
    prev_gen = torch.zeros_like(images_c[0])
    current_state = states[0].to(sdt)
    gen_images, gen_states, encs = [], [], []
    for t in range(images.shape[0] - 1):
        if t < cfg.context_frames:
            prev_image = images_c[t]
        elif uniforms is None:
            prev_image = prev_gen
        else:
            prev_image = sampling.scheduled_sample(
                uniforms[t], images_c[t], prev_gen, n_ground_truth,
                detach_sampled=cfg.detach_sampled)
        state_action = torch.cat([actions[t].to(sdt), current_state],
                                 dim=-1).to(sdt)
        lstm_states, out = step(params, cfg, lstm_states, prev_image,
                                state_action)
        prev_gen, current_state = out.gen_image, out.gen_state
        gen_images.append(out.gen_image)
        gen_states.append(out.gen_state)
        encs.append(out.encs)
    if capture:
        return (torch.stack(gen_images), torch.stack(gen_states),
                tuple(torch.stack(e) for e in zip(*encs)))
    return torch.stack(gen_images), torch.stack(gen_states)


def rollout(params: Params, cfg: ModelConfig, images: torch.Tensor,
            actions: torch.Tensor, states: torch.Tensor, *,
            train: bool = False, iter_num: int = 0,
            generator: Optional[torch.Generator] = None,
            uniforms: Optional[torch.Tensor] = None,
            n_ground_truth=None,
            remat: bool = False, capture: bool = False,
            keys: Optional[Sequence[str]] = None
            ) -> Dict[str, torch.Tensor]:
    """Run the full T-step prediction and compute losses and metrics.

    `train=False` is the feed-self rollout. `train=True` mixes ground
    truth into the fed-back frames by scheduled sampling (unless
    `cfg.scheduled_sampling_k == -1`): `iter_num` sets the count, and
    the (T-1, B) uniforms are drawn once from `generator` (a CPU
    generator; seed 0 when None) and moved to the device in one copy.
    `uniforms` (on the device) and `n_ground_truth` (an int or a 0-d
    device tensor) replace the draw and the count, so that a captured
    CUDA graph can read both from its static inputs.

    Returns the JAX package's dict: loss, psnr_all, gen_images
    (T-1, B, H, W, C), gen_states, per-frame recon/psnr/state curves,
    psnr_per_image, ssim and the (T-ctx, B) matrices, in float32 (float64
    for a float64 model). `keys` limits it to those entries and computes
    only what they need, as XLA drops what a jitted step does not
    return. `capture` adds `conv_res` (the last step's enc0..enc7, as
    the reference's Model.conv_res) and `conv_res_all` (every step's,
    each (T-1, B, ...))."""
    t_total, batch = images.shape[0], images.shape[1]
    n_gt = 0
    if train and cfg.scheduled_sampling_k != -1:
        n_gt = (sampling.num_ground_truth(batch, cfg.scheduled_sampling_k,
                                          iter_num)
                if n_ground_truth is None else n_ground_truth)
        if uniforms is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            uniforms = to_device(torch.rand((t_total - 1, batch),
                                            generator=generator),
                                 images.device)
    else:
        uniforms = None
    frames = rollout_frames(
        params, cfg, images, actions, states, n_ground_truth=n_gt,
        uniforms=uniforms, remat=remat, capture=capture)
    gen_images, gen_states = frames[:2]

    sdt = torch.promote_types(torch.float32, cfg.dtype)
    if not images.is_floating_point():
        images = images.to(torch.float32) / 255.0
    ctx = cfg.context_frames
    true_imgs = images[ctx:].to(sdt)
    pred_imgs = gen_images[ctx - 1:].to(sdt)
    true_states = states[ctx:].to(sdt)
    pred_states = gen_states[ctx - 1:]
    n = t_total - ctx

    def per_frame(fn, a, b):
        return torch.stack([fn(a[i], b[i]) for i in range(n)])

    def recon_costs():
        return per_frame(metrics.mean_squared_error, true_imgs, pred_imgs)

    def state_costs():
        return per_frame(metrics.mean_squared_error, true_states,
                         pred_states) * cfg.state_cost_weight

    def psnrs():
        return per_frame(metrics.peak_signal_to_noise_ratio, true_imgs,
                         pred_imgs)

    def ssim_tb():
        return per_frame(metrics.ssim_per_image, true_imgs, pred_imgs)

    entries = {
        "loss": lambda: (out("recon_costs").sum()
                         + out("state_costs").sum()) / n,
        "psnr_all": lambda: out("psnrs").sum(),
        "gen_images": lambda: gen_images,
        "gen_states": lambda: gen_states,
        "recon_costs": recon_costs,
        "psnrs": psnrs,
        "state_costs": state_costs,
        "psnr_per_image": lambda: per_frame(
            metrics.psnr_per_image, true_imgs, pred_imgs).mean(),
        "ssim": lambda: out("ssim_tb").mean(dim=1).mean(),
        "recon_mse_tb": lambda: per_frame(metrics.per_image_mse, true_imgs,
                                          pred_imgs),
        "state_mse_tb": lambda: per_frame(metrics.per_image_mse,
                                          true_states, pred_states),
        "ssim_tb": ssim_tb,
    }
    done: Dict[str, torch.Tensor] = {}

    def out(key: str) -> torch.Tensor:
        if key not in done:
            done[key] = entries[key]()
        return done[key]

    result = {k: out(k) for k in (entries if keys is None else keys)}
    if capture:
        result["conv_res"] = tuple(e[-1] for e in frames[2])
        result["conv_res_all"] = frames[2]
    return result


@torch.inference_mode()
def predict(params: Params, cfg: ModelConfig, images: torch.Tensor,
            actions: torch.Tensor,
            states: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inference: the feed-self rollout after the context frames."""
    return rollout(params, cfg, images, actions, states, train=False)
