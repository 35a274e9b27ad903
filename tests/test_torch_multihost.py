"""The port's data parallelism (parallel/mesh.py, parallel/multihost.py,
the train step's all-reduce, the loop's multi-process branches) on the
CPU.

The row, batch and device arithmetic is held to the JAX package's for
(process_index, process_count) in {(0,1), (0,2), (1,2), (2,3)}. Then one
two-process gloo run (this file run as a script, the only process spawn
of the port's tests), in float64 at 16x16 and T=4: two train steps of
each rank on its half of a global batch of 4 equal JAX's one-process
steps on the whole batch to 1e-9 (feed-self), and the port's one-process
steps with scheduled sampling on (the global selection: each rank mixes
exactly the rows that the one-process step mixes); the K-step dispatch
equals the steps; agree_flag/agree_string work across the ranks;
validation is the global mean; and a small train loop runs on both
ranks, with rank 0 alone writing its files."""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.data import dataset, synthetic
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.parallel import mesh, multihost
from pivp_tpu_torch.parallel import train_step as ts
from pivp_tpu_torch.training import loop
from pivp_tpu_torch.utils import weights

NARROW = dict(enc_channels=(8, 8, 8, 8, 16, 8, 8),
              lstm_channels=(8, 8, 8, 8, 16, 8, 8))
F64 = dict(image_height=16, image_width=16, num_masks=4, sequence_length=4,
           compute_dtype="float64", lstm_gate_compute="compute", **NARROW)
FEEDSELF = dict(F64, scheduled_sampling_k=-1.0)
T, B, WORLD = 4, 4, 2
LB = B // WORLD
SEED = 7
# n_gt = 2 of the global 4 rows here, so the selection matters.
ITER0 = 6100
STEPS = 2
RANKS = [(0, 1), (0, 2), (1, 2), (2, 3)]


def _global_batches():
    """STEPS time-major global batches (STEPS, T, B, ...), float64."""
    imgs, acts, stas = synthetic.generate_sequences(STEPS * B, T, 16, 16,
                                                    seed=3)
    per = [dataset.to_time_major(imgs[i * B:(i + 1) * B],
                                 acts[i * B:(i + 1) * B],
                                 stas[i * B:(i + 1) * B])
           for i in range(STEPS)]
    return tuple(np.stack(col).astype(np.float64) for col in zip(*per))


def _val_arrays():
    return tuple(a.astype(np.float64) for a in
                 synthetic.generate_sequences(5, T, 16, 16, seed=4))


def _state(cfg):
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    params = predictor.map_params(lambda p: p.to(torch.float64), params)
    return ts.create_train_state(params, ts.make_optimizer(1e-3))


def _steps(cfg, batches, iter0, dp=None):
    """STEPS train steps from the seeded state: (flat params, losses,
    psnrs)."""
    state = _state(cfg)
    step = ts.make_train_step(cfg, dp=dp)
    losses, psnrs = [], []
    for i in range(STEPS):
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[i]))
                      for a in batches)
        state, m = step(state, batch, iter0 + i,
                        sampling.generator(SEED, iter0 + i))
        losses.append(float(m["loss"]))
        psnrs.append(float(m["psnr_all"]))
    return ({k: v.detach().numpy() for k, v
             in weights.flatten(state.params).items()}, losses, psnrs)


# ---------------------------------------------------------------------------
# The worker: one rank of the two-process gloo run.
# ---------------------------------------------------------------------------

def _worker(port: int, rank: int, out: str) -> None:
    torch.set_num_threads(2)
    assert multihost.initialize(f"127.0.0.1:{port}", WORLD, rank,
                                device="cpu")
    assert multihost.process_info() == (rank, WORLD)
    dp = multihost.data_parallel()
    assert dp.backend == "gloo"
    res = {"agree_string": multihost.agree_string(f"run-of-rank-{rank}"),
           "flag_one": multihost.agree_flag(rank == 1),
           "flag_none": multihost.agree_flag(False)}
    arrays = {}
    batches = _global_batches()
    local = multihost.local_columns(batches, B, batch_axis=2)
    for name, kw, iter0 in (("feedself", FEEDSELF, 0),
                            ("sampled", F64, ITER0)):
        cfg = tconfig.ModelConfig(**kw)
        flat, res[f"{name}_loss"], res[f"{name}_psnr"] = _steps(
            cfg, local, iter0, dp)
        arrays.update({f"{name}/{k}": v for k, v in flat.items()})
    # The rank's sampling decisions at each step.
    cfg = tconfig.ModelConfig(**F64)
    for i in range(STEPS):
        u, n = ts.step_sampling(cfg, T, LB, ITER0 + i,
                                sampling.generator(SEED, ITER0 + i), dp=dp)
        arrays[f"mask{i}"] = np.stack([
            (torch.argsort(torch.argsort(row))[:LB] < n).numpy()
            for row in u])
    # K steps a dispatch (eager on the CPU) equal the steps.
    state = _state(cfg)
    state, m = ts.make_train_multi(cfg, dp=dp)(state, local, ITER0, SEED)
    res["multi_loss"] = m["loss"].tolist()
    arrays.update({f"multi/{k}": v.detach().numpy() for k, v
                   in weights.flatten(state.params).items()})
    # Validation over the group.
    state = _state(cfg)
    res["validation"] = loop.run_validation(
        ts.make_eval_step(cfg), state.params, _val_arrays(), B,
        cfg.state_cost_weight, device="cpu", distributed=True)
    # A small train loop: host-sharded batches, an agreed run name, the
    # torch checkpointer written by rank 0.
    tcfg = tconfig.TrainConfig(
        output_dir=os.path.join(out, "models"),
        event_log_dir=os.path.join(out, "models"), num_iterations=4,
        sequence_length=T, batch_size=B, train_val_split=0.75,
        validation_interval=1, save_interval=1, image_height=16,
        image_width=16, num_masks=4, device="cpu", steps_per_call=2,
        prefetch=0, checkpointer="torch",
        model_overrides=tuple(NARROW.items()))
    result = loop.run_training(
        tcfg, arrays=synthetic.generate_sequences(11, T, 16, 16, seed=5))
    res["run_name"] = result["run_name"]
    res["save_dir"] = result["save_dir"]
    res["train_losses"] = result["global_losses"].tolist()
    arrays.update({f"loop/{k}": v.detach().numpy() for k, v
                   in weights.flatten(result["state"].params).items()})
    multihost.shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# Arithmetic against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pi,pc", RANKS)
def test_rows_batches_and_batcher_match_jax(pi, pc):
    from pivp_tpu.parallel import multihost as jmh

    for n in (7, 12, 30):
        assert multihost.shard_rows(n, pi, pc) == jmh.shard_rows(n, pi, pc)
    for gb in (6, 12, 32):
        if gb % pc:
            with pytest.raises(ValueError):
                multihost.local_batch_size(gb, pc)
        else:
            assert (multihost.local_batch_size(gb, pc)
                    == jmh.local_batch_size(gb, pc))
    arrays = (np.arange(12 * 2, dtype=np.float32).reshape(12, 2),) * 3
    got = multihost.HostShardedBatcher(arrays, 6, seed=3, process_index=pi,
                                       process_count=pc)
    want = jmh.HostShardedBatcher(arrays, 6, seed=3, process_index=pi,
                                  process_count=pc)
    for _ in range(5):
        np.testing.assert_array_equal(got.next_indices(),
                                      want.next_indices())
        assert (got.epoch, got.is_new_epoch) == (want.epoch,
                                                 want.is_new_epoch)
    for a, b in zip(got.arrays, want.arrays):
        np.testing.assert_array_equal(a, b)
    got.seek(3)
    want.seek(3)
    np.testing.assert_array_equal(got.next_indices(), want.next_indices())
    if pc > 1:
        with pytest.raises(ValueError, match="equal shards"):
            multihost.HostShardedBatcher(
                tuple(a[:pc * 2 + 1] for a in arrays), 6, seed=3,
                process_index=pi, process_count=pc)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_auto_num_devices_matches_jax(world):
    """JAX counts the visible devices (8 virtual CPUs in the tests); the
    port counts the world's ranks."""
    import jax

    from pivp_tpu.parallel import mesh as jmesh

    for batch in (1, 2, 6, 7, 32):
        for requested in (0, 1, 2, 3, 5):
            if requested == 0 and world != len(jax.devices()):
                continue
            assert (mesh.auto_num_devices(batch, requested, world)
                    == jmesh.auto_num_devices(batch, requested)), \
                (batch, requested)


def test_num_devices_and_spatial_parallel_that_cannot_be_honoured_raise():
    assert mesh.data_parallel_size(32, 0, 1) == 1
    assert mesh.data_parallel_size(32, 2, 2) == 2
    with pytest.raises(ValueError, match="one process per GPU"):
        mesh.data_parallel_size(32, 4, 2)
    with pytest.raises(ValueError, match="does not split"):
        mesh.data_parallel_size(6, 0, 4)
    mesh.check_spatial_parallel(1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.check_spatial_parallel(2)
    cfg = tconfig.TrainConfig(device="cpu", spatial_parallel=2)
    with pytest.raises(NotImplementedError, match="spatial"):
        loop.run_training(cfg, arrays=synthetic.generate_sequences(
            4, T, 16, 16))
    dp = multihost.DataParallel(0, 2)
    with pytest.raises(NotImplementedError, match="grad_accum"):
        ts.make_train_step(tconfig.ModelConfig(**F64), grad_accum=2, dp=dp)


def test_without_a_group_the_collectives_are_identities():
    assert multihost.initialize() is False
    assert multihost.process_info() == (0, 1)
    assert multihost.data_parallel() is None
    assert multihost.agree_string("x") == "x"
    assert multihost.agree_flag(True) is True
    t = torch.arange(6.0).reshape(2, 3)
    assert multihost.gather_columns(t) is t
    batch = (np.arange(T * B * 2).reshape(T, B, 2),)
    np.testing.assert_array_equal(multihost.local_columns(batch, B)[0],
                                  batch[0])


@pytest.mark.parametrize("env, device, backend, want, gpu", [
    # torchrun on 2 hosts x 8 GPUs: rank 9 is local rank 1 of host 1.
    ({"WORLD_SIZE": "16", "RANK": "9", "LOCAL_RANK": "1"}, "cuda", None,
     "nccl", 1),
    ({"WORLD_SIZE": "2", "RANK": "1"}, "cpu", None, "gloo", None),
    # Two ranks sharing one GPU name gloo themselves.
    ({"WORLD_SIZE": "2", "RANK": "1"}, "cuda", "gloo", "gloo", 1),
])
def test_initialize_picks_the_backend(monkeypatch, env, device, backend,
                                      want, gpu):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {}
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(
        multihost.dist, "init_process_group",
        lambda b, **kw: calls.update(backend=b, **kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.update(gpu=d.index))
    assert multihost.initialize(device=device, backend=backend)
    assert calls["backend"] == want
    assert calls.get("gpu") == gpu
    assert (calls["world_size"], calls["rank"]) == (int(env["WORLD_SIZE"]),
                                                    int(env["RANK"]))


# ---------------------------------------------------------------------------
# The two-process run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    """Starts the two gloo ranks, and meanwhile computes the one-process
    references (JAX's steps and the port's) on the global batch."""
    import jax
    import jax.numpy as jnp

    from pivp_tpu import config as jconfig
    from pivp_tpu.parallel import train_step as jts
    from pivp_tpu.utils.checkpoint import flatten_pytree

    out = tempfile.mkdtemp(prefix="pivp-dp-")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(port),
         str(rank), out], env=env, cwd=out, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    try:
        batches = _global_batches()
        ref = {}
        tcfg = tconfig.ModelConfig(**FEEDSELF)
        ref["port_feedself"] = _steps(tcfg, batches, 0)
        ref["port_sampled"] = _steps(tconfig.ModelConfig(**F64), batches,
                                     ITER0)
        state = _state(tcfg)
        flat = weights.to_jax_params(state.params)
        with jax.enable_x64(True):
            jcfg = jconfig.ModelConfig(use_pallas=False, **FEEDSELF)
            jparams = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64),
                weights.unflatten(flat))
            opt = jts.make_optimizer(1e-3)
            jstate = jts.TrainState(jparams, opt.init(jparams), jnp.int32(0))
            step = jts.make_train_step(jcfg, opt)
            losses = []
            for i in range(STEPS):
                jstate, m = step(jstate, tuple(jnp.asarray(a[i])
                                               for a in batches),
                                 jnp.float32(i), jax.random.PRNGKey(0))
                losses.append(float(m["loss"]))
            ref["jax_feedself"] = (flatten_pytree(
                jax.device_get(jstate.params)), losses)
        cfg = tconfig.ModelConfig(**F64)
        ref["validation"] = loop.run_validation(
            ts.make_eval_step(cfg), _state(cfg).params, _val_arrays(), B,
            cfg.state_cost_weight, device="cpu")
        ref["masks"] = []
        for i in range(STEPS):
            u, n = ts.step_sampling(cfg, T, B, ITER0 + i,
                                    sampling.generator(SEED, ITER0 + i))
            ref["masks"].append(np.stack([
                (torch.argsort(torch.argsort(row)) < n).numpy()
                for row in u]))
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    ranks = []
    for rank in range(WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(out, f"rank{rank}.npz")) as z:
            res["arrays"] = {k: z[k] for k in z.files}
        ranks.append(res)
    yield ranks, ref, out


def _params(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res["arrays"].items()
            if k.startswith(prefix + "/")}


def test_two_ranks_equal_jax_one_process_steps_f64(two_ranks):
    ranks, ref, _ = two_ranks
    want, want_loss = ref["jax_feedself"]
    for res in ranks:
        np.testing.assert_allclose(res["feedself_loss"], want_loss,
                                   rtol=1e-9)
        got = weights.to_jax_params(weights.unflatten(
            {k: torch.from_numpy(v) for k, v
             in _params(res, "feedself").items()}))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       atol=1e-12, err_msg=key)


def test_two_ranks_hold_the_global_sampling_selection(two_ranks):
    ranks, ref, _ = two_ranks
    for rank, res in enumerate(ranks):
        for i in range(STEPS):
            np.testing.assert_array_equal(
                res["arrays"][f"mask{i}"],
                ref["masks"][i][:, rank * LB:(rank + 1) * LB])
        want, want_loss, want_psnr = ref["port_sampled"]
        np.testing.assert_allclose(res["sampled_loss"], want_loss,
                                   rtol=1e-9)
        np.testing.assert_allclose(res["sampled_psnr"], want_psnr,
                                   rtol=1e-9)
        for key, v in _params(res, "sampled").items():
            np.testing.assert_allclose(v, want[key], rtol=1e-9, atol=1e-12,
                                       err_msg=key)
        # The K-step dispatch takes the same global steps.
        np.testing.assert_allclose(res["multi_loss"], want_loss, rtol=1e-9)
        for key, v in _params(res, "multi").items():
            np.testing.assert_allclose(v, want[key], rtol=1e-9, atol=1e-12,
                                       err_msg=key)


def test_agree_flag_and_agree_string_across_ranks(two_ranks):
    ranks, _, _ = two_ranks
    for res in ranks:
        assert res["agree_string"] == "run-of-rank-0"
        assert res["flag_one"] is True and res["flag_none"] is False


def test_validation_is_the_global_mean(two_ranks):
    ranks, ref, _ = two_ranks
    for res in ranks:
        assert res["validation"]["n_sequences"] == 5
        for key, want in ref["validation"].items():
            np.testing.assert_allclose(res["validation"][key], want,
                                       rtol=1e-9, err_msg=key)


def test_train_loop_on_two_ranks_writes_from_rank_zero(two_ranks):
    ranks, _, out = two_ranks
    assert ranks[0]["run_name"] == ranks[1]["run_name"]
    assert ranks[0]["save_dir"] == ranks[1]["save_dir"]
    assert ranks[0]["train_losses"] == ranks[1]["train_losses"]
    a, b = _params(ranks[0], "loop"), _params(ranks[1], "loop")
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    run_dir = ranks[0]["save_dir"]
    assert os.path.exists(os.path.join(run_dir, "training-final.npz"))
    assert os.path.exists(os.path.join(run_dir, "full-state.pt"))
    events = os.path.join(out, "models",
                          f"{ranks[0]['run_name']}-events.jsonl")
    with open(events) as f:
        lines = [json.loads(line) for line in f]
    train = [r for r in lines if "train_loss" in r]
    # One line an epoch: rank 1 wrote none.
    assert len(train) == len(ranks[0]["train_losses"])
    assert [r["epoch"] for r in train] == sorted({r["epoch"]
                                                  for r in train})


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
