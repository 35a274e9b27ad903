"""Convolutional LSTM cell on NHWC tensors.

Counterpart of `pivp_tpu/ops/convlstm.py`: one fused gate conv over
concat(input, h) producing 4*out_ch channels split in (j, i, f, o)
order, `c = c*sigmoid(f + forget_bias) + sigmoid(i)*tanh(j)`,
`h = tanh(c)*sigmoid(o)`. The (c, h) carry is explicit.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from pivp_tpu_torch.ops import layers
from pivp_tpu_torch.ops.kernels import lstm_gates


class LSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, W, out_ch)
    h: torch.Tensor  # (B, H, W, out_ch)


def conv_lstm_init(generator: torch.Generator, in_ch: int, out_ch: int,
                   filter_size: int = 5) -> Dict[str, torch.Tensor]:
    """One fused gate conv: concat(x, h) [in_ch+out_ch] -> 4*out_ch."""
    return layers.conv2d_init(generator, in_ch + out_ch, 4 * out_ch,
                              filter_size)


def zero_state(batch: int, height: int, width: int, out_ch: int,
               dtype=torch.float32, device="cpu") -> LSTMState:
    shape = (batch, height, width, out_ch)
    return LSTMState(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def conv_lstm(params: Dict[str, torch.Tensor], state: LSTMState,
              x: torch.Tensor, forget_bias: float = 1.0,
              gate_dtype=torch.float32,
              use_kernel: bool = False) -> Tuple[LSTMState, torch.Tensor]:
    """One ConvLSTM step. Returns (new_state, h).

    `gate_dtype` is the precision of the plain gate math (float32 is the
    reference numerics). `use_kernel=True` runs the gate update through
    `ops/kernels/lstm_gates.fused_lstm_gates` (float32 math at the
    storage type's traffic), which supersedes `gate_dtype`."""
    c, h = state
    inputs_h = torch.cat([x, h.to(x.dtype)], dim=-1)
    gates = layers.conv2d(params, inputs_h, stride=1)
    if use_kernel:
        new_c, new_h = lstm_gates.fused_lstm_gates(
            gates.contiguous(), c.to(gates.dtype).contiguous(), forget_bias)
    else:
        j, i, f, o = torch.chunk(gates, 4, dim=-1)
        cf = c.to(gate_dtype)
        new_c = (cf * torch.sigmoid(f.to(gate_dtype) + forget_bias)
                 + torch.sigmoid(i.to(gate_dtype))
                 * torch.tanh(j.to(gate_dtype)))
        new_h = torch.tanh(new_c) * torch.sigmoid(o.to(gate_dtype))
    new_c = new_c.to(x.dtype)
    new_h = new_h.to(x.dtype)
    return LSTMState(new_c, new_h), new_h
