"""The port's batch assembler (data/assembler.py over
csrc/batch_assembler.cc) on the CPU: payloads bit for bit equal to the
JAX package's `assemble_calls` (float32 and uint8), the native routine
against its numpy version, its uint8 rounding against
`quantize_images`, a lazy store on the numpy path, and the training
loop's dispatch payloads bit for bit what gathering each batch with
`EpochBatcher.next` and stacking them gave before the assembler."""

import numpy as np
import pytest
import torch

from pivp_tpu.data import assembler as jasm
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.data import assembler, dataset, native, synthetic
from pivp_tpu_torch.training import loop

N, T = 9, 4


@pytest.fixture(scope="module")
def arrays():
    imgs, acts, stas = synthetic.generate_sequences(N, T, 16, 16, seed=1)
    # Values outside [0, 1] and on the rounding edges of the u8 mapping.
    imgs = imgs.copy()
    imgs[0, 0, 0, :4, 0] = [-0.1, 1.2, 0.5 / 255, 254.5 / 255]
    return imgs, acts, stas


def _idx(k, b, seed=0):
    return np.random.RandomState(seed).randint(0, N, (k, b)).astype(np.int64)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("k,b", [(1, 3), (3, 2), (2, 9)])
def test_assemble_calls_matches_jax_and_the_numpy_version(arrays, quantize,
                                                          k, b):
    idx = _idx(k, b)
    before = native.assemble.calls
    got = assembler.assemble_calls(arrays, idx, quantize)
    assert native.assemble.calls == before + 1
    want = jasm.assemble_calls(arrays, idx, quantize)
    plain = assembler.assemble_calls_plain(arrays, idx, quantize)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype
        assert g.shape == w.shape and g.shape[:3] == (k, T, b)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
        assert g.flags["C_CONTIGUOUS"]


def test_native_u8_equals_the_loops_quantization():
    rng = np.random.RandomState(2)
    imgs = rng.uniform(-0.2, 1.2, (4, 2, 8, 8, 3)).astype(np.float32)
    # Every u8 rounding edge, and just below and above it.
    edges = (np.arange(256, dtype=np.float32) + 0.5) / 255
    imgs.reshape(-1)[:3 * 256] = np.concatenate(
        [edges, np.nextafter(edges, -1), np.nextafter(edges, 2)])
    idx = np.arange(4, dtype=np.int64).reshape(1, 4)
    got = native.assemble(imgs, idx, quantize=True)
    want = assembler.quantize_images(np.swapaxes(imgs, 0, 1))[None]
    np.testing.assert_array_equal(got, want)


def test_lazy_store_takes_the_numpy_path(arrays, tmp_path):
    synthetic.write_processed_dir(str(tmp_path), 5, T, 16, 16, seed=3)
    lazy = dataset.lazy_sequences(str(tmp_path))
    ram = dataset.load_sequences(str(tmp_path))
    assert not assembler.native_ok(lazy[0]) and assembler.native_ok(ram[0])
    idx = _idx(2, 3) % 5
    before = native.assemble.calls
    got = assembler.assemble_calls(lazy, idx, True)
    assert native.assemble.calls == before
    for g, w in zip(got, assembler.assemble_calls(ram, idx, True)):
        np.testing.assert_array_equal(g, w)
    # Non-contiguous or non-float32 images take it too.
    assert not assembler.native_ok(ram[0][:, ::2])
    assert not assembler.native_ok(ram[0].astype(np.float64))


def test_native_assemble_rejects_what_it_cannot_take(arrays):
    with pytest.raises(IndexError):
        native.assemble(arrays[0], np.array([[0, N]]), False)
    with pytest.raises(IndexError):
        native.assemble(arrays[0], np.array([[-1, 0]]), False)
    with pytest.raises(ValueError):
        native.assemble(arrays[0].astype(np.float64), _idx(1, 2), False)
    with pytest.raises(ValueError):
        native.assemble(arrays[0][:, ::2], _idx(1, 2), False)
    with pytest.raises(ValueError):
        native.assemble(arrays[0], np.arange(3), False)


def _stacked_calls(batcher, k_total, k, quantize):
    """The loop's payloads as it built them before the assembler:
    batcher.next() per step, quantized per batch, stacked over the
    dispatch."""
    out = []
    for _ in range(0, k_total, k):
        batches = []
        for _ in range(k):
            batch = batcher.next()
            if quantize:
                batch = (assembler.quantize_images(batch[0]),) + batch[1:]
            batches.append(batch)
        out.append(tuple(np.stack(col) for col in zip(*batches)))
    return out


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("u8", [True, False])
def test_loop_payloads_stay_bit_for_bit(arrays, k, u8):
    cfg = tconfig.TrainConfig(device="cpu", batch_size=4, num_iterations=6,
                              steps_per_call=k, u8_transfer=u8,
                              sequence_length=T, image_height=16,
                              image_width=16)
    mcfg = cfg.model_config()
    want = _stacked_calls(dataset.EpochBatcher(arrays, 4, seed=5), 6, k, u8)
    calls = loop._produce_calls(dataset.EpochBatcher(arrays, 4, seed=5),
                                cfg, 0, k, 11, mcfg, "cpu")
    got = list(calls)
    assert len(got) == len(want)
    for (payload, kk, _), w in zip(got, want):
        assert kk == k
        if k == 1:
            tensors = payload
            w = tuple(a[0] for a in w)
        else:
            views = payload.views()
            tensors = (views["images"], views["actions"], views["states"])
        for t, a in zip(tensors, w):
            assert t.dtype == torch.from_numpy(a).dtype
            assert torch.equal(t, torch.from_numpy(np.ascontiguousarray(a)))
