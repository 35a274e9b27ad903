"""Flat-npz save/load of the port's parameters and optimizer state, and
the run directory.

Counterpart of the npz and run-directory parts of
`pivp_tpu/utils/checkpoint.py`: the same '/'-joined keys, and the files
hold the JAX package's weight layouts (utils/weights.py maps them), so a
`training-<tag>.npz` or `state-<tag>.npz` written by either package
loads into the other, for the CDNA, DNA and STP heads (per-mask STP
projections under `head/identity_params/<i>/`). A run directory
`<date>-<TYPE>-<batch>/` holds those files, the metric-curve `.npy`
files and a `version` file stamping the git commit.

`convert_reference_npz` / `export_reference_npz` read and write the
Chainer reference's `serializers.save_npz(Model)` layout (the
counterpart of the JAX package's converter, with its own copy of the
key and layout map).
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, Optional

import numpy as np
import torch

from pivp_tpu_torch.utils import weights


def flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's nested parameter dict -> '/'-keyed numpy arrays in the
    JAX package's layouts (the npz contract)."""
    return weights.to_jax_params(tree)


def save_npz(path: str, tree: Dict[str, Any]) -> None:
    """Write atomically: to a temp file in the same directory, then
    os.replace, so a crash mid-write never leaves a truncated file at the
    final name."""
    out = path if path.endswith(".npz") else path + ".npz"
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(tmp, out)


def load_npz_into(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Load a flat npz into the structure of `template`: same keys and
    shapes, each tensor on the template tensor's device and dtype."""
    with np.load(path) as data:
        stored = weights.flatten(weights.from_jax_params(dict(data)))
    out = {}
    for key, leaf in weights.flatten(template).items():
        if key not in stored:
            raise KeyError(f"checkpoint missing key {key}")
        value = stored[key]
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(leaf.shape)}")
        out[key] = value.to(device=leaf.device, dtype=leaf.dtype)
    return weights.unflatten(out)


def npz_keys(path: str):
    """List checkpoint keys."""
    with np.load(path) as data:
        return sorted(data.keys())


# The Chainer reference's flattened LayerNorms, each normalizing one
# stage's (H, W, C) volume: its gamma and beta are (C*H*W,) vectors in
# CHW order. Values: (resolution index, channel plan, channel index).
_LAYER_NORMS = {
    "norm_enc0": (1, "enc", 0), "norm_enc6": (0, "enc", 6),
    "hidden1": (1, "lstm", 0), "hidden2": (1, "lstm", 1),
    "hidden3": (2, "lstm", 2), "hidden4": (2, "lstm", 3),
    "hidden5": (3, "lstm", 4), "hidden6": (2, "lstm", 5),
    # lstm7 runs at H/2 resolution, unlike lstm3-6.
    "hidden7": (1, "lstm", 6),
}


def _layer_norm_shapes(cfg) -> Dict[str, tuple]:
    """Each LayerNorm's (H, W, C)."""
    from pivp_tpu_torch.models.predictor import _resolutions

    res = _resolutions(cfg)
    plans = {"enc": cfg.enc_channels, "lstm": cfg.lstm_channels}
    return {name: (*res[r], plans[plan][i])
            for name, (r, plan, i) in _LAYER_NORMS.items()}


def _hidden5_chw(cfg) -> tuple:
    """hidden5's (C, H, W), the feature map the CDNA and STP dense layers
    read flattened: HWC-flat here, CHW-flat in the reference."""
    from pivp_tpu_torch.models.predictor import _resolutions

    h8, w8 = _resolutions(cfg)[3]
    return (cfg.lstm_channels[4], h8, w8)


def convert_reference_npz(path: str, cfg,
                          params_template: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a Chainer reference `serializers.save_npz(Model)`
    checkpoint into the port's parameter dict, each tensor on the
    template tensor's device and dtype.

    Layout mapping (the reference's NCHW layers -> the port's layouts):
      * conv W (out, in, kh, kw) and deconv W (in, out, kh, kw) are the
        port's own layouts and pass unchanged;
      * linear W (out, in) is the port's dense layout, with the input
        dim re-permuted from CHW-flat to HWC-flat where it reads a
        feature map (cdna_kerns, stp_input on hidden5);
      * LayerNormalization gamma/beta (C*H*W,) -> scale/bias (H, W, C).
    Per-mask STP's projections are `model/identity_params_<i>`."""
    with np.load(path) as data:
        ref = dict(data)

    def layer(name):
        return {"w": ref[name + "/W"], "b": ref[name + "/b"]}

    def linear(name, chw=None):
        w = ref[name + "/W"]
        if chw is not None:
            w = w.reshape(w.shape[0], *chw).transpose(0, 2, 3, 1)
            w = w.reshape(w.shape[0], -1)
        return {"w": w, "b": ref[name + "/b"]}

    def ln(name, shape):
        h, w, c = shape
        return {k: ref[f"{name}/norm/{r}"].reshape(c, h, w).transpose(1, 2, 0)
                for k, r in (("scale", "gamma"), ("bias", "beta"))}

    out: Dict[str, Any] = {f"enc{i}": layer(f"enc{i}") for i in range(7)}
    for i in range(1, 8):
        out[f"lstm{i}"] = layer(f"lstm{i}/conv")
    for name, shape in _layer_norm_shapes(cfg).items():
        out[name] = ln(name, shape)
    out["masks"] = layer("masks")
    out["state_pred"] = linear("current_state")
    head: Dict[str, Any] = {"enc7": layer("model/enc7")}
    if cfg.is_cdna:
        head["cdna_kerns"] = linear("model/cdna_kerns", _hidden5_chw(cfg))
    elif cfg.is_stp:
        head["stp_input"] = linear("model/stp_input", _hidden5_chw(cfg))
        if cfg.stp_shared_params:
            head["identity_params"] = linear("model/identity_params")
        else:
            head["identity_params"] = {
                str(i): linear(f"model/identity_params_{i}")
                for i in range(cfg.num_masks - 1)}
    out["head"] = head

    converted = weights.flatten(out)
    params = {}
    for key, leaf in weights.flatten(params_template).items():
        if key not in converted:
            raise KeyError(f"converter missing {key}")
        value = converted[key]
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"converted {key}: {tuple(value.shape)} != "
                             f"{tuple(leaf.shape)}")
        params[key] = torch.as_tensor(np.ascontiguousarray(value)).to(
            device=leaf.device, dtype=leaf.dtype)
    return weights.unflatten(params)


def export_reference_npz(path: str, cfg, params: Dict[str, Any]) -> None:
    """Inverse of `convert_reference_npz`: write the port's params in the
    Chainer reference's npz key layout, as the JAX package's
    `export_reference_npz` writes its own."""
    flat = {k: v.detach().to("cpu").numpy()
            for k, v in weights.flatten(params).items()}
    out: Dict[str, np.ndarray] = {}

    def put(name, layer):
        out[name + "/W"] = flat[layer + "/w"]
        out[name + "/b"] = flat[layer + "/b"]

    def put_linear(name, layer, chw=None):
        w = flat[layer + "/w"]
        if chw is not None:
            c, h, w_ = chw
            w = w.reshape(w.shape[0], h, w_, c).transpose(0, 3, 1, 2)
            w = w.reshape(w.shape[0], -1)
        out[name + "/W"] = w
        out[name + "/b"] = flat[layer + "/b"]

    for i in range(7):
        put(f"enc{i}", f"enc{i}")
    for i in range(1, 8):
        put(f"lstm{i}/conv", f"lstm{i}")
    for name in _LAYER_NORMS:
        out[name + "/norm/gamma"] = np.transpose(
            flat[name + "/scale"], (2, 0, 1)).reshape(-1)
        out[name + "/norm/beta"] = np.transpose(
            flat[name + "/bias"], (2, 0, 1)).reshape(-1)
    put("masks", "masks")
    put_linear("current_state", "state_pred")
    put("model/enc7", "head/enc7")
    if cfg.is_cdna:
        put_linear("model/cdna_kerns", "head/cdna_kerns", _hidden5_chw(cfg))
    elif cfg.is_stp:
        put_linear("model/stp_input", "head/stp_input", _hidden5_chw(cfg))
        if cfg.stp_shared_params:
            put_linear("model/identity_params", "head/identity_params")
        else:
            for i in range(cfg.num_masks - 1):
                put_linear(f"model/identity_params_{i}",
                           f"head/identity_params/{i}")
    np.savez(path, **out)


def git_version() -> Optional[str]:
    """Branch + commit provenance stamp, or None outside a git checkout
    (or without git)."""
    try:
        def run(args):
            return subprocess.run(["git"] + args, capture_output=True,
                                  text=True, check=True,
                                  timeout=30).stdout.strip()
        return run(["rev-parse", "--abbrev-ref", "HEAD"]) + "\n" + \
            run(["rev-parse", "HEAD"])
    except (OSError, subprocess.SubprocessError):
        return None


def prepare_run_dir(output_dir: str, run_name: str) -> str:
    """Create `output_dir/run_name` (with its `version` stamp) if it does
    not exist yet; return its path."""
    save_dir = os.path.join(output_dir, run_name)
    if not os.path.exists(save_dir):
        os.makedirs(save_dir, exist_ok=True)
        version = git_version()
        if version is not None:
            with open(os.path.join(save_dir, "version"), "w") as f:
                f.write(version + "\n")
    return save_dir
