"""The weight bridge between the JAX package's parameters and the port's.

Both packages key parameters by the same '/'-joined paths
(`enc0/w`, `lstm3/b`, `head/cdna_kerns/w`, ...). They differ in the
weight layouts:

  * conv        JAX (kh, kw, in, out)  ->  port (out, in, kh, kw)
  * deconv      JAX (kh, kw, in, out)  ->  port (in, out, kh, kw), the
                `conv_transpose2d` weight, with no spatial flip
  * dense       JAX (in, out)          ->  port (out, in)
  * LayerNorm scale/bias and all biases keep their shape.

With these mappings an npz written by either package loads into the
other (utils/checkpoint.py writes the JAX layout). The per-mask STP
projections, a list in the JAX package (flattened to
`head/identity_params/<i>/w|b`), are a dict keyed "0", "1", ... in the
port (models/heads.py), which flattens to the same keys; each is a dense
layer, and DNA's `head/enc7` a transposed conv with K*K outputs. The
optimizer state (`count`, `mu/<param key>`, `nu/<param key>`, the JAX
ChainerAdamState) crosses the same way: each moment takes its
parameter's layout, and `count` passes unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# Layers whose 4-D weight is a transposed conv; every other 4-D weight
# is a conv.
DECONV_LAYERS = frozenset({"enc4", "enc5", "enc6", "masks", "head/enc7"})


# Prefixes of the optimizer's moment trees: a moment has the layout of
# the parameter its key names after the prefix.
_MOMENT_PREFIXES = ("mu/", "nu/")


def _layer(key: str) -> str:
    for prefix in _MOMENT_PREFIXES:
        if key.startswith(prefix):
            key = key[len(prefix):]
            break
    return key.rsplit("/", 1)[0]


def _jax_to_port(key: str, a: np.ndarray) -> np.ndarray:
    if not key.endswith("/w"):
        return a
    if a.ndim == 4:
        perm = (2, 3, 0, 1) if _layer(key) in DECONV_LAYERS else (3, 2, 0, 1)
        return np.transpose(a, perm)
    if a.ndim == 2:
        return a.T
    return a


def _port_to_jax(key: str, a: np.ndarray) -> np.ndarray:
    if not key.endswith("/w"):
        return a
    if a.ndim == 4:
        perm = (2, 3, 0, 1) if _layer(key) in DECONV_LAYERS else (2, 3, 1, 0)
        return np.transpose(a, perm)
    if a.ndim == 2:
        return a.T
    return a


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'/'-joined key: leaf}."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'/'-joined key: leaf} -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The JAX package's parameters, flat and as numpy arrays, -> the
    port's nested dict of contiguous CPU tensors in PyTorch layouts
    (torch.tensor keeps a transposed array's strides, which would hand
    the convolutions weights in another memory layout than
    `init_params` makes)."""
    return unflatten({k: torch.tensor(np.require(
        _jax_to_port(k, np.asarray(v)), requirements="C"))
        for k, v in flat.items()})


def to_jax_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's nested parameter dict -> the JAX package's flat
    '/'-keyed numpy arrays."""
    # np.require keeps a 0-d leaf (the optimizer's count) 0-d, where
    # np.ascontiguousarray would make it 1-d.
    return {
        k: np.require(_port_to_jax(k, v.detach().to("cpu").numpy()),
                      requirements="C")
        for k, v in flatten(params).items()}
