"""The local-apply kernel's plain PyTorch version (what the port's wrapper
computes on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode and its shifted-stack reference. The CUDA kernel itself
is held against the plain version on the card (test_torch_gpu.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops.pallas import local_apply as jla
from pivp_tpu_torch.ops.kernels import local_apply as tla


def _data(b, h, w, c, k, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, h, w, c).astype(np.float32)
    wts = r.rand(b, h, w, k * k).astype(np.float32)
    return x, wts / wts.sum(-1, keepdims=True)


@pytest.mark.parametrize("shape,k", [
    ((2, 8, 8, 3), 5),
    ((2, 8, 8, 3), 3),
    ((1, 12, 10, 5), 5),          # non-square frame, C not a multiple of 4
    ((1, 136, 8, 3), 5),          # H > 128: the JAX tiled layout's regime
])
def test_plain_matches_pallas_interpret(shape, k):
    x, w = _data(*shape, k)
    want_pallas = np.asarray(jla.local_kernel_apply(jnp.asarray(x),
                                                    jnp.asarray(w), True))
    want_ref = np.asarray(jla.local_kernel_apply_reference(
        jnp.asarray(x), jnp.asarray(w)))
    got = tla.local_kernel_apply(torch.as_tensor(x), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_counts_no_launch():
    x, w = _data(1, 6, 6, 3, 5)
    before = tla.local_kernel_apply.launches
    tla.local_kernel_apply(torch.as_tensor(x), torch.as_tensor(w))
    assert tla.local_kernel_apply.launches == before


def test_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd square"):
        tla.local_kernel_apply_plain(torch.zeros(1, 4, 4, 3),
                                     torch.zeros(1, 4, 4, 16))


def test_rejects_meta_device():
    x = torch.empty(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tla.local_kernel_apply(x, torch.empty(1, 4, 4, 25, device="meta"))


SHAPES = [
    ((2, 8, 8, 3), 5),
    ((2, 8, 8, 3), 3),
    ((1, 12, 10, 5), 5),          # non-square frame, C not a multiple of 4
    ((1, 136, 8, 3), 5),          # H > 128: the JAX tiled layout's regime
]


@pytest.mark.parametrize("shape,k", SHAPES)
def test_bwd_plain_matches_pallas_interpret(shape, k):
    x, w = _data(*shape, k)
    g = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want_dx, want_dw = jla._bwd_call(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(g), True)
    got_dx, got_dw = tla.local_kernel_apply_bwd_plain(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(g))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_autograd_matches_jax_grad_of_pallas_vjp(shape, k):
    x, w = _data(*shape, k)
    g = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = jax.grad(
        lambda a, b: jnp.sum(jla.local_kernel_apply(a, b, True) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (tla.local_kernel_apply(xt, wt) * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,k", [((1, 5, 4, 2), 3), ((2, 4, 6, 1), 5)])
def test_gradcheck_float64(shape, k):
    r = np.random.RandomState(3)
    x = torch.tensor(r.randn(*shape), requires_grad=True)
    w = torch.tensor(r.randn(*shape[:3], k * k), requires_grad=True)
    assert torch.autograd.gradcheck(tla.local_kernel_apply, (x, w),
                                    eps=1e-6, atol=1e-8, rtol=1e-6)


def test_cpu_backward_counts_no_launch():
    x, w = (torch.tensor(a, requires_grad=True)
            for a in _data(1, 6, 6, 3, 5))
    counts = (tla.local_kernel_apply_bwd_w.launches,
              tla.local_kernel_apply_bwd_x.launches)
    tla.local_kernel_apply(x, w).sum().backward()
    assert (tla.local_kernel_apply_bwd_w.launches,
            tla.local_kernel_apply_bwd_x.launches) == counts
    assert x.grad is not None and w.grad is not None


# The tile plan of the CUDA forward and dW kernels: computed here, on the
# CPU, and passed to the kernels, which check it against their own
# shared-memory layout.
PLAN_SHAPES = [(32, 64, 64, 3), (4, 256, 256, 3), (1, 4, 2048, 3)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_plan_fits_and_covers_the_frame(shape, k, dtype):
    b, h, w, _ = shape
    plan = tla.tile_plan(shape, k, dtype)
    assert plan.smem <= tla.SMEM_LIMIT == 232448
    assert plan.rows * plan.cols <= tla.TILE_THREADS
    # Block (bx, by, bz) owns rows [by*rows, +rows) and columns
    # [bx*cols, +cols) of sample bz, clipped to the frame, as the kernel
    # reads blockIdx.
    hits = np.zeros((b, h, w), np.int32)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            hits[:, by * plan.rows:(by + 1) * plan.rows,
                 bx * plan.cols:(bx + 1) * plan.cols] += 1
    assert plan.grid[2] == b
    assert (hits == 1).all()
    if shape == PLAN_SHAPES[0]:
        assert np.prod(plan.grid) >= 132          # the H100's SMs


def test_tile_plan_smem_matches_the_kernel_layout():
    # At the main shape in float32: tiles of 1 row x 64 columns. The x
    # rows 2 above to 2 below the tile are one span of 5 * 192 floats,
    # after 8 floats (the 6-float halo before it, rounded to 16 bytes) and
    # before 6 (the halo after it): 974 floats, 3,904 bytes aligned.
    plan = tla.tile_plan((32, 64, 64, 3), 5, torch.float32)
    assert (plan.rows, plan.cols) == (1, 64)
    assert plan.grid == (1, 64, 32)
    want = 64 * 25 * 4 + 3904 + 64 * 3 * 4
    assert plan.smem == want == 11072
    # A column strip keeps its halo columns in each row, 256 + 4 columns:
    # (8 + 5 * 260 * 3 + 6) floats, 15,656 bytes, 15,664 aligned.
    strip = tla.tile_plan((1, 4, 2048, 3), 5, torch.float32)
    assert strip.grid == (8, 4, 1)
    assert strip.smem == 256 * 25 * 4 + 15664 + 256 * 3 * 4


def test_tile_plan_shrinks_a_tile_to_fit():
    plan = tla.tile_plan((1, 8, 64, 600), 7, torch.float32)
    assert plan.smem <= tla.SMEM_LIMIT
    assert plan.smem == tla.tile_smem_bytes(plan.rows, plan.cols, 64, 600,
                                            7, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tla.tile_plan((1, 8, 64, 5000), 7, torch.float32)


@pytest.mark.parametrize("shape,k,dtype,edge", [
    ((4, 67, 32, 3), 5, torch.float32, "ragged rows"),
    ((1, 4, 2048, 3), 5, torch.float32, "column strips"),
    ((2, 37, 13, 3), 5, torch.bfloat16, "unaligned spans"),
])
def test_gpu_cases_reach_the_tile_edges(shape, k, dtype, edge):
    # The shapes that test_torch_gpu.py adds for the tiled kernels reach
    # the edge they are there for.
    b, h, w, _ = shape
    plan = tla.tile_plan(shape, k, dtype)
    if edge == "ragged rows":
        assert h % plan.rows != 0
    elif edge == "column strips":
        assert plan.cols < w
    else:
        # Full-width dW spans start at (b*H + h0) * W*K*K elements, in
        # bytes a multiple of 16 for some row tiles and not for others.
        starts = {(i * h + h0) * w * k * k * 2 % 16
                  for i in range(b) for h0 in range(0, h, plan.rows)}
        assert plan.cols == w and 0 in starts and len(starts) > 1


# The dX kernel's own plan: taller tiles, since it stages w and g with a
# halo of K//2 rows above and below.
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_x_tile_plan_fits_and_covers_the_frame(shape, k, dtype):
    b, h, w, c = shape
    plan = tla.tile_plan_bwd_x(shape, k, dtype)
    # The kernel's 8-byte barrier is static shared memory.
    assert plan.smem + 8 <= tla.SMEM_LIMIT
    per, threads = tla.bwd_x_block(k, c)
    assert plan.rows % per == 0
    assert plan.rows // per * plan.cols <= threads
    assert threads == (256 if (k, c) == (5, 3) else 1024)
    hits = np.zeros((b, h, w), np.int32)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            hits[:, by * plan.rows:(by + 1) * plan.rows,
                 bx * plan.cols:(bx + 1) * plan.cols] += 1
    assert plan.grid[2] == b
    assert (hits == 1).all()
    if shape == PLAN_SHAPES[0]:
        assert np.prod(plan.grid) >= 132          # the H100's SMs


def test_bwd_x_tile_plan_smem_matches_the_kernel_layout():
    # At the main shape in float32: tiles of 8 rows x 64 columns. The w
    # rows 2 above to 2 below the tile are one span of 12 * 1600 floats,
    # after 52 (the 50-float halo before it, rounded to 16 bytes) and
    # before 50 (the halo after it): 19,302 floats, 77,216 bytes aligned.
    # g likewise: 8 + 12 * 192 + 6 floats, 9,280 bytes aligned; then the
    # dX tile, 8 * 64 * 3 floats. A thread takes two rows of a column:
    # 256 threads a block.
    plan = tla.tile_plan_bwd_x((32, 64, 64, 3), 5, torch.float32)
    assert tla.bwd_x_block(5, 3) == (2, 256)
    assert (plan.rows, plan.cols) == (8, 64)
    assert plan.grid == (1, 8, 32)
    assert plan.smem == 77216 + 9280 + 8 * 64 * 3 * 4 == 92640
    # A column strip keeps its halo columns in each row, 256 + 4 columns:
    # (52 + 6 * 260 * 25 + 50) floats of w, 156,416 bytes aligned, and
    # (8 + 6 * 260 * 3 + 6) of g, 18,784 aligned, for tiles of 2 rows.
    strip = tla.tile_plan_bwd_x((1, 4, 2048, 3), 5, torch.float32)
    assert (strip.rows, strip.cols, strip.grid) == (2, 256, (8, 2, 1))
    assert strip.smem == 156416 + 18784 + 2 * 256 * 3 * 4


@pytest.mark.parametrize("shape,k,dtype,edge", [
    ((4, 67, 32, 3), 5, torch.float32, "ragged rows"),
    ((1, 4, 2048, 3), 5, torch.float32, "column strips"),
    ((2, 37, 13, 3), 5, torch.bfloat16, "unaligned spans"),
])
def test_gpu_cases_reach_the_bwd_x_tile_edges(shape, k, dtype, edge):
    # The shapes of test_torch_gpu.py reach the same edges in dX's plan.
    b, h, w, c = shape
    plan = tla.tile_plan_bwd_x(shape, k, dtype)
    if edge == "ragged rows":
        assert h % plan.rows != 0
    elif edge == "column strips":
        assert plan.cols < w
    else:
        # Full-width dX spans start at (b*H + h0) * W*C elements, in bytes
        # a multiple of 16 for some row tiles and not for others.
        starts = {(i * h + h0) * w * c * 2 % 16
                  for i in range(b) for h0 in range(0, h, plan.rows)}
        assert plan.cols == w and 0 in starts and len(starts) > 1
