"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the kernel rollout against the plain-op rollout.

Every test here is marked `gpu` and skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed; run it
there with `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(the repo's conftest.py sets JAX up)."""

import contextlib
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops.kernels import local_apply as la
from pivp_tpu_torch.ops.kernels import lstm_gates as lg
from pivp_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


# The tiled kernels' edges (test_torch_local_apply.py checks that each
# shape reaches its edge in the forward and dW plan and in dX's): rows
# that the tile does not divide, column strips of a wide frame,
# full-width spans of W=13 that are 16-byte aligned in bfloat16 only for
# some tiles, and 256x256.
LOCAL_APPLY_CASES = [
    ((2, 16, 16, 3), 5), ((2, 16, 16, 3), 3), ((1, 9, 13, 1), 5),
    ((1, 20, 7, 8), 7), ((1, 300, 17, 5), 5), ((4, 67, 32, 3), 5),
    ((1, 4, 2048, 3), 5), ((2, 37, 13, 3), 5), ((2, 256, 256, 3), 5)]


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol), \
        float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("shape,k", LOCAL_APPLY_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_local_apply_kernel_matches_plain(cuda, shape, k, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.rand(shape[:3] + (k * k,), generator=g, device=cuda)
    w = (w / w.sum(-1, keepdim=True)).to(dtype)
    before = la.local_kernel_apply.launches
    got = la.local_kernel_apply(x, w)
    assert la.local_kernel_apply.launches == before + 1
    _close(got, la.local_kernel_apply_plain(x, w), tol)


@pytest.mark.parametrize("C", [32, 64, 128, 3])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_lstm_gates_kernel_matches_plain(cuda, C, forget_bias, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(C)
    gates = (torch.randn((2, 8, 8, 4 * C), generator=g, device=cuda)
             * 1.5).to(dtype)
    c = torch.randn((2, 8, 8, C), generator=g, device=cuda).to(dtype)
    before = lg.fused_lstm_gates.launches
    got = lg.fused_lstm_gates(gates, c, forget_bias)
    assert lg.fused_lstm_gates.launches == before + 1
    want = lg.fused_lstm_gates_plain(gates, c, forget_bias)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 3, device=cuda)
    w = torch.zeros(1, 4, 4, 25, device=cuda)
    with pytest.raises(TypeError):
        la.local_kernel_apply(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        la.local_kernel_apply(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="devices"):
        la.local_kernel_apply(x, w.cpu())
    gates = torch.zeros(1, 4, 4, 12, device=cuda)
    with pytest.raises(TypeError):
        lg.fused_lstm_gates(gates.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        lg.fused_lstm_gates(gates.transpose(1, 2), x.transpose(1, 2))


def test_kernel_rollout_matches_plain_rollout(cuda):
    cfg = ModelConfig(image_height=32, image_width=32, sequence_length=5)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=cuda)
    r = np.random.RandomState(0)
    data = [torch.as_tensor(a, device=cuda) for a in (
        r.rand(5, 4, 32, 32, 3).astype(np.float32),
        r.randn(5, 4, 5).astype(np.float32),
        r.randn(5, 4, 5).astype(np.float32))]
    la.local_kernel_apply.launches = lg.fused_lstm_gates.launches = 0
    out_k = predictor.predict(params, cfg, *data)
    assert la.local_kernel_apply.launches == 4
    assert lg.fused_lstm_gates.launches == 28
    plain = dataclasses.replace(cfg, use_kernel=False, use_kernel_gates=False)
    out_p = predictor.predict(params, plain, *data)
    _close(out_k["gen_images"], out_p["gen_images"], 1e-4)
    assert float((out_k["psnrs"] - out_p["psnrs"]).abs().max()) <= 0.01


@pytest.mark.parametrize("shape,k", LOCAL_APPLY_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_local_apply_bwd_kernels_match_plain(cuda, shape, k, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.rand(shape[:3] + (k * k,), generator=g, device=cuda)
    w = (w / w.sum(-1, keepdim=True)).to(dtype)
    before = (la.local_kernel_apply_bwd_w.launches,
              la.local_kernel_apply_bwd_x.launches)
    dw = la.local_kernel_apply_bwd_w(x, gy, k)
    dx = la.local_kernel_apply_bwd_x(w, gy)
    assert (la.local_kernel_apply_bwd_w.launches,
            la.local_kernel_apply_bwd_x.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want_dx, want_dw = la.local_kernel_apply_bwd_plain(x, w, gy)
    _close(dw, want_dw, tol)
    _close(dx, want_dx, tol)


def test_local_apply_autograd_launches_both_backward_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 8, 8, 3), generator=g, device=cuda,
                    requires_grad=True)
    w = torch.rand((2, 8, 8, 25), generator=g, device=cuda,
                   requires_grad=True)
    before = (la.local_kernel_apply_bwd_w.launches,
              la.local_kernel_apply_bwd_x.launches)
    la.local_kernel_apply(x, w).square().sum().backward()
    assert (la.local_kernel_apply_bwd_w.launches,
            la.local_kernel_apply_bwd_x.launches) == (before[0] + 1,
                                                      before[1] + 1)
    xc, wc = (t.detach().cpu().requires_grad_() for t in (x, w))
    la.local_kernel_apply(xc, wc).square().sum().backward()
    _close(x.grad.cpu(), xc.grad, 1e-5)
    _close(w.grad.cpu(), wc.grad, 1e-5)


@pytest.mark.parametrize("C", [32, 64, 128, 3])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("missing", [None, "c", "h"])
def test_lstm_gates_bwd_kernel_matches_plain(cuda, C, forget_bias, dtype,
                                             tol, missing):
    g = torch.Generator(device=cuda).manual_seed(C)
    gates = (torch.randn((2, 8, 8, 4 * C), generator=g, device=cuda)
             * 1.5).to(dtype)
    c, g_c, g_h = (torch.randn((2, 8, 8, C), generator=g,
                               device=cuda).to(dtype) for _ in range(3))
    g_c = None if missing == "c" else g_c
    g_h = None if missing == "h" else g_h
    before = lg.fused_lstm_gates_bwd.launches
    got = lg.fused_lstm_gates_bwd(gates, c, g_c, g_h, forget_bias)
    assert lg.fused_lstm_gates_bwd.launches == before + 1
    want = lg.fused_lstm_gates_bwd_plain(gates, c, g_c, g_h, forget_bias)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)


def test_train_step_grads_with_kernels_match_plain(cuda):
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts

    cfg = ModelConfig(image_height=32, image_width=32, sequence_length=5)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=cuda)
    state = ts.create_train_state(params, ts.make_optimizer(1e-3))
    r = np.random.RandomState(0)
    batch = [torch.as_tensor(a, device=cuda) for a in (
        r.rand(5, 4, 32, 32, 3).astype(np.float32),
        r.randn(5, 4, 5).astype(np.float32),
        r.randn(5, 4, 5).astype(np.float32))]
    plain = dataclasses.replace(cfg, use_kernel=False, use_kernel_gates=False)
    for it in (0, 6000):
        la.local_kernel_apply_bwd_x.launches = 0
        lg.fused_lstm_gates_bwd.launches = 0
        got, _ = ts.grads_and_metrics(state.params, cfg, batch, it,
                                      sampling.generator(0, it))
        assert la.local_kernel_apply_bwd_x.launches == 4
        assert lg.fused_lstm_gates_bwd.launches == 28
        want, _ = ts.grads_and_metrics(state.params, plain, batch, it,
                                       sampling.generator(0, it))
        for a, b in zip(got, want):
            assert float((a - b).norm() / (b.norm() + 1e-30)) <= 1e-4


@pytest.mark.parametrize("shape", [(32, 64, 64, 3), (2, 37, 13, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_apply_kernels_repeat_bit_for_bit(cuda, shape, dtype):
    # Gathers without atomics: two launches give the same bits.
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.rand(shape[:3] + (25,), generator=g, device=cuda).to(dtype)
    assert torch.equal(la.local_kernel_apply(x, w),
                       la.local_kernel_apply(x, w))
    assert torch.equal(la.local_kernel_apply_bwd_w(x, gy, 5),
                       la.local_kernel_apply_bwd_w(x, gy, 5))
    assert torch.equal(la.local_kernel_apply_bwd_x(w, gy),
                       la.local_kernel_apply_bwd_x(w, gy))


@pytest.mark.parametrize("name,plan_of", [
    ("pivp_local_apply_fwd", la.tile_plan),
    ("pivp_local_apply_bwd_w", la.tile_plan),
    ("pivp_local_apply_bwd_x", la.tile_plan_bwd_x)])
def test_local_apply_kernels_reject_a_plan_off_their_layout(cuda, name,
                                                            plan_of):
    # Each kernel checks the wrapper's tile plan against its own shared
    # memory layout and refuses to launch on a mismatch.
    a = torch.zeros(2, 16, 16, 3, device=cuda)
    b = torch.zeros(2, 16, 16, 25, device=cuda)
    plan = plan_of(a.shape, 5, a.dtype)
    bad = dataclasses.replace(plan, smem=plan.smem + 16)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        la._launch(name, a, b, torch.empty_like(a), a.shape, 5, bad)


def test_dna_apply_kernels_on_a_strided_enc7_slice(cuda):
    """DNA's kernel logits are a channel slice of the merged masks+enc7
    conv (last-dim stride 27): dna_apply hands the kernels contiguous
    operands, and its forward and both backward kernels launch and agree
    with the shifted-stack form, in values and gradients."""
    from pivp_tpu_torch.ops import transforms

    g = torch.Generator(device=cuda).manual_seed(4)
    prev = torch.rand((4, 64, 64, 3), generator=g, device=cuda)
    merged = torch.randn((4, 64, 64, 27), generator=g, device=cuda)
    merged.requires_grad_()
    assert not merged[..., 2:].is_contiguous()
    counts = (la.local_kernel_apply, la.local_kernel_apply_bwd_w,
              la.local_kernel_apply_bwd_x)
    before = [f.launches for f in counts]
    prev_k = prev.clone().requires_grad_()
    got = transforms.dna_apply(prev_k, merged[..., 2:],
                               local_apply=la.local_kernel_apply)
    gy = torch.randn(got.shape, generator=g, device=cuda)
    got_g = torch.autograd.grad(got, (prev_k, merged), gy)
    assert [f.launches for f in counts] == [n + 1 for n in before]
    prev_p = prev.clone().requires_grad_()
    want = transforms.dna_apply(prev_p, merged[..., 2:])
    want_g = torch.autograd.grad(want, (prev_p, merged), gy)
    _close(got, want, 1e-5)
    for a, b in zip(got_g, want_g):
        _close(a, b, 1e-5)


def _op_inputs(name):
    """CPU inputs of each `torch.ops.pivp` op at a small size."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand(2, 16, 16, 3, generator=g)
    w = torch.rand(2, 16, 16, 25, generator=g)
    gy = torch.randn(2, 16, 16, 3, generator=g)
    gates = torch.randn(2, 8, 8, 128, generator=g)
    c, g_h = (torch.randn(2, 8, 8, 32, generator=g) for _ in range(2))
    return {"local_apply_fwd": (x, w), "local_apply_bwd_w": (x, gy, 5),
            "local_apply_bwd_x": (w, gy),
            "lstm_gates_fwd": (gates, c, 1.0),
            "lstm_gates_bwd": (gates, c, None, g_h, 1.0)}[name]


@pytest.mark.parametrize("name", ["local_apply_fwd", "local_apply_bwd_w",
                                  "local_apply_bwd_x", "lstm_gates_fwd",
                                  "lstm_gates_bwd"])
def test_op_cuda_implementation_matches_cpu(cuda, name):
    """Each op's CUDA implementation (the kernel) against its CPU one
    (the plain version) on the same inputs, within float32 rounding of
    two orders of summation and two sets of transcendental functions
    (1e-5); and opcheck of the op on the card."""
    op = getattr(torch.ops.pivp, name)
    args = _op_inputs(name)
    on_card = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a
                    for a in args)
    got, want = op(*on_card), op(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.device.type == "cuda"
        _close(a.cpu(), b, 1e-5)
    torch.library.opcheck(op, on_card)


@pytest.mark.parametrize("head", [{}, dict(model_type="STP")],
                         ids=["CDNA", "STP"])
def test_artifact_frames_equal_make_serve_fn_on_the_card(cuda, head,
                                                         tmp_path):
    """A small artifact exported and loaded on the card holds the kernel
    ops, launches the kernels, and its frames equal make_serve_fn's bit
    for bit under cudnn.deterministic (cuDNN's default algorithm for the
    transposed convolutions is not reproducible from run to run)."""
    from pivp_tpu_torch.inference import export

    cfg = ModelConfig(image_height=32, image_width=32, sequence_length=5,
                      **head)
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=cuda)
    path = str(tmp_path / "serve.pt2")
    export.export_serving_artifact(params, cfg, 4, path)
    serve = export.load_serving_artifact(path)
    local = 0 if cfg.is_stp else 4
    assert export.kernel_nodes(serve.exported) == dict(
        lstm_gates_fwd=28, **({"local_apply_fwd": 4} if local else {}))
    r = np.random.RandomState(0)
    request = (r.rand(2, 4, 32, 32, 3).astype(np.float32),
               r.randn(4, 4, 5).astype(np.float32),
               r.randn(4, 5).astype(np.float32))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        la.local_kernel_apply.launches = lg.fused_lstm_gates.launches = 0
        got = serve(*request)
        assert la.local_kernel_apply.launches == local
        assert lg.fused_lstm_gates.launches == 28
        want = export.make_serve_fn(params, cfg)(*request)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got, want)


def _graph_setup(cuda, head):
    from pivp_tpu_torch.data import synthetic
    from pivp_tpu_torch.parallel import train_step as ts

    cfg = ModelConfig(image_height=32, image_width=32, sequence_length=5,
                      **head)

    def state():
        params = predictor.init_params(torch.Generator().manual_seed(0),
                                       cfg, device=cuda)
        return ts.create_train_state(params, ts.make_optimizer(1e-3))

    imgs, acts, stas = synthetic.generate_sequences(4, 5, 32, 32, seed=1)
    batches = tuple(np.stack([a[2 * i:2 * i + 2].swapaxes(0, 1)
                              for i in range(2)])
                    for a in (imgs, acts, stas))
    u8 = np.clip(batches[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return cfg, state, (u8,) + batches[1:]


@pytest.mark.parametrize("head", [{}, dict(model_type="STP")],
                         ids=["CDNA", "STP"])
def test_graphed_steps_equal_eager_steps_on_the_card(cuda, head):
    """Two steps at b2 as replays of the captured train step equal two
    eager steps bit for bit under cudnn.deterministic: parameters, Adam
    state and per-step metrics; the counters see each replay launch the
    captured kernels."""
    from pivp_tpu_torch.ops import sampling
    from pivp_tpu_torch.parallel import train_step as ts

    cfg, new_state, batches = _graph_setup(cuda, head)
    it0, seed = 6100, 3
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, step = new_state(), ts.make_train_step(cfg)
        want = []
        for i in range(2):
            batch = tuple(torch.as_tensor(a[i], device=cuda)
                          for a in batches)
            _, m = step(eager, batch, it0 + i,
                        sampling.generator(seed, it0 + i))
            want.append((m["loss"], m["psnr_all"]))
        graphed, multi = new_state(), ts.make_train_multi(cfg)
        counters = ts._launch_counters()
        before = [fn.launches for fn in counters]
        _, got = multi(graphed, batches, it0, seed)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    local = 0 if cfg.is_stp else 4
    assert multi.captured.launches == (local, 28, local, local, 28)
    # Two warm-up steps run eagerly before the capture, then two replays.
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        4 * n for n in multi.captured.launches]
    assert multi.captured.capture_s > 0 and multi.captured.pool_bytes > 0
    assert graphed.step == eager.step == 2
    for x, y in zip(graphed.leaves(), eager.leaves()):
        assert torch.equal(x, y)
    for key, x in ts.weights.flatten(ts.opt_state_tree(graphed)).items():
        assert torch.equal(x, ts.weights.flatten(
            ts.opt_state_tree(eager))[key]), key
    for i, (loss, psnr) in enumerate(want):
        assert torch.equal(got["loss"][i], loss)
        assert torch.equal(got["psnr_all"][i], psnr)


def test_native_assembler_feeds_make_train_multi_on_the_card(cuda):
    """The loop's payload path on the card: the native assembler gathers
    a K-step call (uint8 frames) from the batcher's indices, bit for bit
    the stacked batches, and make_train_multi replays its captured step
    on it."""
    from pivp_tpu_torch.data import assembler, dataset, native, synthetic
    from pivp_tpu_torch.parallel import train_step as ts

    cfg, new_state, _ = _graph_setup(cuda, {})
    arrays = synthetic.generate_sequences(6, 5, 32, 32, seed=2)
    idx = np.stack([dataset.EpochBatcher(arrays, 2, seed=1).next_indices()
                    for _ in range(2)])
    before = native.assemble.calls
    payload = assembler.assemble_calls(arrays, idx, quantize=True)
    assert native.assemble.calls == before + 1
    for got, want in zip(payload, assembler.assemble_calls_plain(
            arrays, idx, quantize=True)):
        assert np.array_equal(got, want)
    state, multi = new_state(), ts.make_train_multi(cfg)
    call = ts.stage_call(cfg, payload, 6100, 3, pin=True)
    _, m = multi(state, call, 6100, 3)
    torch.cuda.synchronize()
    assert multi.captured is not None and state.step == 2
    assert torch.isfinite(m["loss"]).all()
    assert all(torch.isfinite(p).all() for p in state.leaves())


def test_world_one_nccl_group_captured_step_equals_no_group(cuda):
    """A world-1 NCCL process group around the captured train step: the
    gradient all-reduce is captured in the graph, and two replays equal
    two replays without a group bit for bit under cudnn.deterministic."""
    import socket

    import torch.distributed as dist

    from pivp_tpu_torch.parallel import multihost
    from pivp_tpu_torch.parallel import train_step as ts

    cfg, new_state, batches = _graph_setup(cuda, {})
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = new_state()
        _, want = ts.make_train_multi(cfg)(alone, batches, 6100, 3)
        assert multihost.initialize(f"127.0.0.1:{port}", 1, 0,
                                    device="cuda")
        try:
            assert dist.get_backend() == "nccl"
            dp = multihost.data_parallel()
            grouped, multi = new_state(), ts.make_train_multi(cfg, dp=dp)
            _, got = multi(grouped, batches, 6100, 3)
            torch.cuda.synchronize()
        finally:
            multihost.shutdown()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert multi.captured is not None
    for x, y in zip(grouped.leaves(), alone.leaves()):
        assert torch.equal(x, y)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["psnr_all"], want["psnr_all"])


@contextlib.contextmanager
def _thread_querying_events():
    """A thread that, until the block ends, makes the CUDA calls the
    loop's prefetch thread makes while it pins payloads: pinned
    allocations and event queries (the host allocator's). Yields a list
    that holds the thread's round count and then any error it met."""
    stop, out = threading.Event(), [0]
    event = torch.cuda.Event()
    event.record(torch.cuda.Stream())

    def run():
        try:
            while not stop.is_set():
                torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True)
                event.query()
                out[0] += 1
        except Exception as e:  # handed to the test, which fails on it
            out.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()


def test_capture_survives_another_thread_querying_events(cuda):
    """The train step is captured while another thread pins buffers and
    queries events, as the loop's prefetch thread does during a run's
    first dispatch; the replays still equal a capture made alone."""
    from pivp_tpu_torch.parallel import train_step as ts

    cfg, new_state, batches = _graph_setup(cuda, {})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = new_state()
        _, want = ts.make_train_multi(cfg)(alone, batches, 0, 0)
        busy, multi = new_state(), ts.make_train_multi(cfg)
        with _thread_querying_events() as thread:
            _, got = multi(busy, batches, 0, 0)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert thread[0] > 0 and thread[1:] == []
    assert torch.equal(got["loss"], want["loss"])
    for x, y in zip(busy.leaves(), alone.leaves()):
        assert torch.equal(x, y)


def test_step_timer_times_the_device(cuda):
    from pivp_tpu_torch.utils import profiling

    timer = profiling.StepTimer(cuda)
    x = torch.randn(1024, 1024, device=cuda)
    for _ in range(3):
        timer.start()
        x = x @ x / 1024
        timer.stop()
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["min_s"] > 0


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A step that cannot be captured (here: it reads a value back to the
    host) raises; the dispatch does not fall back to eager steps. Last in
    the file: a failed capture can leave the device's stream state
    behind."""
    from pivp_tpu_torch.parallel import train_step as ts

    cfg, new_state, batches = _graph_setup(cuda, {})
    apply = ts._apply

    def syncing(state, grads):
        float(grads[0].sum())
        apply(state, grads)

    monkeypatch.setattr(ts, "_apply", syncing)
    state = new_state()
    with pytest.raises(RuntimeError):
        ts.make_train_multi(cfg)(state, batches, 0, 0)
    assert state.step == 0
