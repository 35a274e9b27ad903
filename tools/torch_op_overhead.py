#!/usr/bin/env python3
"""What it costs, called from Python, to reach a CUDA kernel of the
PyTorch port through the dispatcher.

For the local-apply forward (x (32,64,64,3), w (32,64,64,25), float32)
and the gate forward (gates (32,32,32,128), c (32,32,32,32), one cell
of lstm1), the shapes of `chip_smoke.py`'s phase 3, three routes to the
same launch:

  launch     the op's CUDA implementation called as a Python function
             (checks, tile plan, ctypes launch, count): the wrapper as
             it was before the kernels became ops
  library    the wrapper, through the op that `torch.library.Library`
             defines (`define`/`impl`, the form the port uses)
  custom_op  the same CUDA implementation registered with the decorator
             `torch.library.custom_op` (in a namespace of its own)

Each is timed as `chip_smoke.py` times "called from Python": CUDA events
around 200 back-to-back calls after 20 warm-up calls, the mean per call.
The routes go in turns (launch, library, custom_op, custom_op, library,
launch), --rounds times, and every time is printed.

Usage: python3 tools/torch_op_overhead.py [--rounds 3]
Needs a GPU.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from pivp_tpu_torch.ops.kernels import local_apply as la  # noqa: E402
from pivp_tpu_torch.ops.kernels import lstm_gates as lg  # noqa: E402
from pivp_tpu_torch.utils.device import resolve_device  # noqa: E402


def custom_ops():
    """The two forward launches registered with the decorator form."""
    @torch.library.custom_op("pivp_overhead::local_apply_fwd",
                             mutates_args=(), device_types="cuda")
    def local_apply_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return la._fwd_cuda(x, w)

    @local_apply_fwd.register_fake
    def _(x, w):
        return x.new_empty(x.shape)

    @torch.library.custom_op("pivp_overhead::lstm_gates_fwd",
                             mutates_args=(), device_types="cuda")
    def lstm_gates_fwd(gates: torch.Tensor, c: torch.Tensor,
                       forget_bias: float) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        return lg._fwd_cuda(gates, c, forget_bias)

    @lstm_gates_fwd.register_fake
    def _(gates, c, forget_bias):
        return c.new_empty(c.shape), c.new_empty(c.shape)

    return local_apply_fwd, lstm_gates_fwd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    resolve_device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{chip_smoke.card_line()}; torch {torch.__version__}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, _, w = chip_smoke.la_inputs(chip_smoke.LOCAL_APPLY_SHAPE, 5,
                                   torch.float32, gen)
    gates, c = chip_smoke.gate_inputs((32, 32, 32, 32), torch.float32, gen,
                                      1)
    la_custom, lg_custom = custom_ops()
    cases = {
        "local_apply_fwd": {
            "launch": lambda: la._fwd_cuda(x, w),
            "library": lambda: la.local_kernel_apply_fwd(x, w),
            "custom_op": lambda: la_custom(x, w)},
        "lstm_gates_fwd": {
            "launch": lambda: lg._fwd_cuda(gates, c, 1.0),
            "library": lambda: lg.fused_lstm_gates_fwd(gates, c, 1.0),
            "custom_op": lambda: lg_custom(gates, c, 1.0)},
    }
    for name, routes in cases.items():
        for route, fn in routes.items():
            want = routes["launch"]()
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise SystemExit(f"{name} {route}: differs from the launch")
        order = ["launch", "library", "custom_op"]
        times = {r: [] for r in order}
        for _ in range(args.rounds):
            for route in order + order[::-1]:
                times[route].append(chip_smoke.cuda_ms(routes[route]) * 1e3)
        for route in order:
            ts = sorted(times[route])
            print(f"{name} {route}: us per call from Python "
                  + " ".join(f"{t:.2f}" for t in times[route])
                  + f" (median {ts[len(ts) // 2]:.2f})", flush=True)


if __name__ == "__main__":
    main()
