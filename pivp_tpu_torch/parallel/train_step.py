"""Train and eval steps on one device.

Counterpart of `pivp_tpu/parallel/train_step.py` without the mesh: one
step is the scheduled-sampling rollout, its backward (through the
kernels' autograd Functions) and a Chainer-exact Adam update, in place on
the parameter tensors. Metrics stay device tensors, so no step waits on
the device; the training loop reads them at the epoch flush.

`make_train_multi` runs K steps per dispatch. Their inputs (the batches,
and each step's scheduled-sampling uniforms and ground-truth count,
drawn on the host) are staged in one byte buffer, which reaches the GPU
in one host-to-device copy. On the GPU one train step is captured once
as a CUDA graph and replayed for each step; on the CPU the same staged
steps run eagerly.

Data parallelism (`dp`, a multihost.DataParallel): each rank runs the
step on its own columns of the global batch, then all-reduces the
gradients (one flat buffer, summed, divided by the world size) before
Adam, and the step metrics with them, so every rank applies the same
update, as JAX's one program over the global batch does. Scheduled
sampling stays global: every rank draws the global batch's uniforms and
ground-truth count, ranks all of them, and keeps its own columns
(step_sampling).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import metrics as metrics_lib
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.ops.kernels import local_apply, lstm_gates
from pivp_tpu_torch.parallel.multihost import DataParallel
from pivp_tpu_torch.utils import weights
from pivp_tpu_torch.utils.device import to_device

logger = logging.getLogger(__name__)

# Metrics carried out of the train step (the reference's summary set);
# SSIM and per-image PSNR stay in the eval step.
_METRIC_KEYS = ("loss", "psnr_all", "recon_costs", "psnrs", "state_costs")
# What validation consumes: the per-(frame, sequence) metric matrices.
_EVAL_METRIC_KEYS = ("recon_mse_tb", "state_mse_tb", "ssim_tb")

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


class ChainerAdam(torch.optim.Optimizer):
    """Adam with Chainer's exact update rule (the reference optimizer,
    `chainer_adam` in the JAX package):

        m  <- m + (1-b1) (g - m)
        v  <- v + (1-b2) (g^2 - v)
        p  <- p - alpha_t * m / (sqrt(v) + eps),
              alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t)

    eps is added to the square root of the uncorrected second moment,
    where torch.optim.Adam adds it to the bias-corrected one. Each
    parameter's state holds `count`, `mu` and `nu`; the step count is
    one 0-d device tensor that every parameter of a group shares (the
    JAX state's one `count`), and alpha_t is computed from it on the
    device, in the parameters' type, so a step reads no host value and a
    CUDA graph of it replays correctly."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    def init_state(self) -> None:
        """Create the step count and the zero moments of every parameter
        now (a step creates them when they are missing)."""
        for group in self.param_groups:
            self._group_count(group)

    def _group_count(self, group) -> torch.Tensor:
        params = group["params"]
        count = next((self.state[p]["count"] for p in params
                      if "count" in self.state[p]), None)
        if count is None:
            count = torch.zeros((), dtype=torch.int64,
                                device=params[0].device)
        for p in params:
            st = self.state[p]
            if "mu" not in st:
                st["count"] = count
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
        return count

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainerAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            count = self._group_count(group)
            count.add_(1)
            neg_alpha = {}
            for p in params:
                st = self.state[p]
                g, mu, nu = p.grad, st["mu"], st["nu"]
                mu.add_(g - mu, alpha=1.0 - b1)
                nu.add_(g * g - nu, alpha=1.0 - b2)
                if p.dtype not in neg_alpha:
                    t = count.to(p.dtype)
                    neg_alpha[p.dtype] = -(group["lr"] * torch.sqrt(
                        1.0 - b2 ** t) / (1.0 - b1 ** t))
                p.add_(neg_alpha[p.dtype] * mu / (nu.sqrt() + eps))


def make_optimizer(learning_rate: float = 1e-3,
                   flavor: str = "chainer") -> OptimizerFactory:
    """Adam with the reference's (Chainer-default) hyperparameters:
    alpha=lr, beta1=0.9, beta2=0.999, eps=1e-8. 'chainer' (default) is
    the reference's exact rule (ChainerAdam); 'adam' is torch's Adam (eps
    inside the bias-corrected denominator). Returns a factory that takes
    the parameter tensors."""
    if flavor == "chainer":
        return lambda ps: ChainerAdam(ps, learning_rate)
    if flavor == "adam":
        return lambda ps: torch.optim.Adam(ps, learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer flavor {flavor!r}")


@dataclasses.dataclass
class TrainState:
    """Parameters (a nested dict of leaf tensors), the optimizer over
    them in `weights.flatten` order, and the number of steps taken."""
    params: Dict
    optimizer: torch.optim.Optimizer
    step: int = 0

    def leaves(self) -> List[torch.Tensor]:
        return list(weights.flatten(self.params).values())


def create_train_state(params: Dict,
                       make_opt: OptimizerFactory) -> TrainState:
    """A TrainState over `params`, whose tensors become the optimized
    leaves (requires_grad on)."""
    for p in weights.flatten(params).values():
        p.requires_grad_(True)
    return TrainState(params, make_opt(list(weights.flatten(
        params).values())))


def opt_state_tree(state: TrainState) -> Dict:
    """The optimizer state as the JAX package's ChainerAdamState tree:
    {"count": int32 scalar, "mu": params-shaped, "nu": params-shaped}
    (zeros before the first step). This is what `state-<tag>.npz`
    holds."""
    flat = weights.flatten(state.params)
    count, mu, nu = 0, {}, {}
    for key, p in flat.items():
        st = state.optimizer.state.get(p, {})
        count = max(count, int(st.get("count", 0)))
        mu[key] = st["mu"].detach() if "mu" in st else torch.zeros_like(p)
        nu[key] = st["nu"].detach() if "nu" in st else torch.zeros_like(p)
    return {"count": torch.tensor(count, dtype=torch.int32),
            "mu": weights.unflatten(mu), "nu": weights.unflatten(nu)}


def load_opt_state_tree(state: TrainState, tree: Dict) -> None:
    """Restore a ChainerAdamState tree (see opt_state_tree) into the
    optimizer, on each parameter's device and dtype. The optimizer's
    state tensors are written in place, so a captured train step (see
    make_train_multi) keeps reading them."""
    count = int(tree["count"])
    mu, nu = weights.flatten(tree["mu"]), weights.flatten(tree["nu"])
    opt = state.optimizer
    if isinstance(opt, ChainerAdam):
        opt.init_state()
    with torch.no_grad():
        for key, p in weights.flatten(state.params).items():
            st = opt.state[p]
            if "mu" not in st:
                st["count"] = torch.zeros((), dtype=torch.int64,
                                          device=p.device)
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            st["count"].fill_(count)
            st["mu"].copy_(mu[key])
            st["nu"].copy_(nu[key])


def _check_dp(dp: Optional[DataParallel], grad_accum: int) -> None:
    if dp is not None and dp.world > 1 and grad_accum > 1:
        raise NotImplementedError(
            "--grad_accum > 1 with several data-parallel ranks is not "
            "supported: JAX's microbatches are slices of the global batch "
            "that straddle the ranks' columns, each with its own sampling "
            "inputs (ROADMAP.md, 'Modules to port')")


def step_sampling(cfg: ModelConfig, t_total: int, batch: int,
                  iter_num: int, generator: Optional[torch.Generator],
                  grad_accum: int = 1, dp: Optional[DataParallel] = None
                  ) -> Tuple[Optional[torch.Tensor], int]:
    """One train step's scheduled-sampling inputs, drawn on the host:
    the uniforms (T-1, B) float32 on the CPU and the ground-truth count
    of a (micro)batch, or (None, 0) when sampling is off. Microbatch g
    of `grad_accum` draws its columns from a generator folded from the
    step's seed and g, as the JAX package folds its key.

    With `dp`, `batch` is the rank's share: the uniforms are the global
    batch's (T-1, B * world) and the count is the global batch's, as
    JAX draws them for its one program. They come rotated so that this
    rank's columns lead (`sampling.scheduled_sample` ranks all of them
    and keeps the leading ones), so every rank mixes exactly the rows
    that the one-process step over the global batch mixes."""
    if batch % grad_accum:
        raise ValueError(f"batch {batch} not divisible by grad_accum "
                         f"{grad_accum}")
    _check_dp(dp, grad_accum)
    if cfg.scheduled_sampling_k == -1:
        return None, 0
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if dp is not None and dp.world > 1:
        total = batch * dp.world
        n_gt = sampling.num_ground_truth(total, cfg.scheduled_sampling_k,
                                         iter_num)
        uniforms = torch.rand((t_total - 1, total), generator=generator)
        return torch.roll(uniforms, -dp.rank * batch, dims=1), n_gt
    mb = batch // grad_accum
    n_gt = sampling.num_ground_truth(mb, cfg.scheduled_sampling_k,
                                     iter_num)
    if grad_accum <= 1:
        return torch.rand((t_total - 1, batch), generator=generator), n_gt
    seed = generator.initial_seed()
    return torch.cat([
        torch.rand((t_total - 1, mb), generator=sampling.generator(seed, g))
        for g in range(grad_accum)], dim=1), n_gt


def _all_reduce_mean(tensors: List[torch.Tensor],
                     dp: DataParallel) -> List[torch.Tensor]:
    """The ranks' mean of each tensor: one flat buffer, all-reduced
    (sum) over the group and divided by the world size."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=dp.group)
    flat = flat / dp.world
    return [part.view_as(t) for part, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors)]


def _reduce_metrics(metrics: Dict, dp: DataParallel) -> Dict:
    """Global-batch metrics from the ranks': the loss and the per-frame
    costs are batch means, so their means over equal shares are the
    global ones; PSNR, a function of the batch MSE, is recomputed from
    the reduced recon costs."""
    linear = [k for k in ("loss", "recon_costs", "state_costs")
              if k in metrics]
    out = dict(metrics)
    out.update(zip(linear, _all_reduce_mean([metrics[k] for k in linear],
                                            dp)))
    if "recon_costs" in out:
        out["psnrs"] = metrics_lib._psnr(out["recon_costs"])
        out["psnr_all"] = out["psnrs"].sum()
    return out


def _loss_fn(params, cfg: ModelConfig, batch: Batch, uniforms, n_gt,
             remat: bool):
    images, actions, states = batch
    out = predictor.rollout(params, cfg, images, actions, states,
                            train=True, uniforms=uniforms,
                            n_ground_truth=n_gt, remat=remat,
                            keys=_METRIC_KEYS)
    return out["loss"], out


def _grads(params, cfg: ModelConfig, batch: Batch, uniforms, n_gt,
           remat: bool, grad_accum: int, dp: Optional[DataParallel] = None
           ) -> Tuple[List[torch.Tensor], Dict]:
    """Gradients and detached metrics of one step whose sampling inputs
    are given (device tensors, or None and 0 without sampling); with
    `dp`, the ranks' means (a world of one leaves the metrics as they
    are: it has nothing to average)."""
    grads, metrics = _local_grads(params, cfg, batch, uniforms, n_gt,
                                  remat, grad_accum)
    if dp is not None:
        grads = _all_reduce_mean(grads, dp)
        if dp.world > 1:
            metrics = _reduce_metrics(metrics, dp)
    return grads, metrics


def _local_grads(params, cfg: ModelConfig, batch: Batch, uniforms, n_gt,
                 remat: bool, grad_accum: int
                 ) -> Tuple[List[torch.Tensor], Dict]:
    leaves = list(weights.flatten(params).values())
    if grad_accum <= 1:
        loss, out = _loss_fn(params, cfg, batch, uniforms, n_gt, remat)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in out.items()}

    mb = batch[0].shape[1] // grad_accum
    g_sum: Optional[List[torch.Tensor]] = None
    m_sum: Dict[str, torch.Tensor] = {}
    for g in range(grad_accum):
        cols = slice(g * mb, (g + 1) * mb)
        micro = tuple(a[:, cols] for a in batch)
        loss, out = _loss_fn(params, cfg, micro,
                             None if uniforms is None else uniforms[:, cols],
                             n_gt, remat)
        grads = torch.autograd.grad(loss, leaves)
        g_sum = (list(grads) if g_sum is None
                 else [a + d for a, d in zip(g_sum, grads)])
        for k, v in out.items():
            m_sum[k] = m_sum[k] + v.detach() if k in m_sum else v.detach()
    inv = 1.0 / grad_accum
    return ([x * inv for x in g_sum],
            {k: v * inv for k, v in m_sum.items()})


def grads_and_metrics(params, cfg: ModelConfig, batch: Batch,
                      iter_num: int, generator: torch.Generator,
                      remat: bool = False, grad_accum: int = 1,
                      dp: Optional[DataParallel] = None
                      ) -> Tuple[List[torch.Tensor], Dict]:
    """Gradients (in `weights.flatten(params)` order) and detached
    metrics, optionally over `grad_accum` contiguous microbatches. The
    loss is a batch mean, so the mean of the microbatch gradients is
    exact; metrics become means of the per-microbatch values. The
    scheduled-sampling uniforms come from `generator` (see
    step_sampling). With `dp` the batch is the rank's share of the
    global batch, and the gradients and metrics are the global ones."""
    uniforms, n_gt = step_sampling(cfg, batch[0].shape[0],
                                   batch[0].shape[1], iter_num, generator,
                                   grad_accum, dp)
    if uniforms is not None:
        uniforms = to_device(uniforms, batch[0].device)
    return _grads(params, cfg, batch, uniforms, n_gt, remat, grad_accum, dp)


def _apply(state: TrainState, grads: List[torch.Tensor]) -> None:
    for p, g in zip(state.leaves(), grads):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)


def make_train_step(cfg: ModelConfig, remat: bool = False,
                    grad_accum: int = 1, dp: Optional[DataParallel] = None):
    """Build step(state, (images, actions, states), iter_num, generator)
    -> (state, metrics). Batches are time-major (T, B, ...) on the
    parameters' device; the update is in place and `state.step` counts
    it. `generator` (a CPU torch.Generator) draws the scheduled-sampling
    uniforms. With `dp` each rank passes its share of the global batch
    and takes the global step (see the module docstring)."""
    _check_dp(dp, grad_accum)

    def train_step(state: TrainState, batch: Batch, iter_num: int,
                   generator: torch.Generator):
        grads, metrics = grads_and_metrics(
            state.params, cfg, batch, iter_num, generator, remat,
            grad_accum, dp)
        _apply(state, grads)
        state.step += 1
        return state, metrics

    return train_step


# Bytes between the fields of a staged call (a multiple of every
# element size, and of the 16 bytes a vector load wants).
_ALIGN = 64


@dataclasses.dataclass
class StagedCall:
    """The inputs of K train steps in one uint8 buffer: `layout` holds
    (name, byte offset, dtype, shape) of each field: "images" (K, T, B,
    H, W, C) uint8 or float, "actions" (K, T, B, A), "states" (K, T, B,
    S), and with scheduled sampling "uniforms" (K, T-1, B) float32 and
    "n_gt" (K,) int64. `iter0` and `seed` are the absolute iteration of
    the first step and the base seed its sampling inputs were drawn
    from."""
    buffer: torch.Tensor
    layout: Tuple[Tuple[str, int, torch.dtype, Tuple[int, ...]], ...]
    k: int
    iter0: int
    seed: int

    def views(self, buffer: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """Typed views of the fields in `buffer` (default: the host
        buffer; pass its copy on the device to read that)."""
        buf = self.buffer if buffer is None else buffer
        out = {}
        for name, off, dtype, shape in self.layout:
            n = int(np.prod(shape)) * dtype.itemsize
            out[name] = buf[off:off + n].view(dtype).view(shape)
        return out


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def stage_call(cfg: ModelConfig, batches, iter0: int, seed: int,
               grad_accum: int = 1, pin: bool = False,
               dp: Optional[DataParallel] = None) -> StagedCall:
    """Stage K steps' inputs for make_train_multi: the batches
    (images, actions, states), each (K, T, B, ...), and, with scheduled
    sampling, step k's uniforms and ground-truth count drawn from
    `sampling.generator(seed, iter0 + k)` exactly as the one-step path
    draws them (with `dp`, the global batch's, rotated to this rank: see
    step_sampling). `pin` puts the buffer in page-locked memory, from
    which the copy to a GPU does not wait for the host."""
    images, actions, states = (_as_tensor(a) for a in batches)
    k, t_total, batch = images.shape[:3]
    fields = [("images", images), ("actions", actions), ("states", states)]
    if cfg.scheduled_sampling_k != -1:
        draws = [step_sampling(cfg, t_total, batch, iter0 + i,
                               sampling.generator(seed, iter0 + i),
                               grad_accum, dp) for i in range(k)]
        fields += [("uniforms", torch.stack([u for u, _ in draws])),
                   ("n_gt", torch.tensor([n for _, n in draws],
                                         dtype=torch.int64))]
    layout, off = [], 0
    for name, a in fields:
        layout.append((name, off, a.dtype, tuple(a.shape)))
        off += -(-a.numel() * a.element_size() // _ALIGN) * _ALIGN
    buffer = torch.empty((off,), dtype=torch.uint8, pin_memory=pin)
    staged = StagedCall(buffer, tuple(layout), k, iter0, seed)
    for (name, a), view in zip(fields, staged.views().values()):
        view.copy_(a)
    return staged


def _launch_counters():
    """The kernel wrappers' launch counters, in the order of
    CapturedStep.launches."""
    return (local_apply.local_kernel_apply, lstm_gates.fused_lstm_gates,
            local_apply.local_kernel_apply_bwd_w,
            local_apply.local_kernel_apply_bwd_x,
            lstm_gates.fused_lstm_gates_bwd)


def _add_launches(counts) -> None:
    for fn, n in zip(_launch_counters(), counts):
        fn.launches += n


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step writes: the parameters, their moments and the
    optimizer's step counts."""
    out = state.leaves()
    seen = set()
    for p in state.leaves():
        st = state.optimizer.state[p]
        out += [st["mu"], st["nu"]]
        if id(st["count"]) not in seen:
            seen.add(id(st["count"]))
            out.append(st["count"])
    return out


# Eager steps before a capture: the first builds the kernels and picks
# cuDNN's algorithms, the second runs as every later step does.
_WARMUP_STEPS = 2


class CapturedStep:
    """One train step captured as a CUDA graph over a state's tensors.

    Its static inputs (`inputs`, one step's fields of a StagedCall) are
    written before each `replay`, and `metrics` holds (loss, psnr_all)
    after it. Before capture the step runs _WARMUP_STEPS times eagerly
    on a side stream, and the state is then put back as it was,
    so the graph's first replay is the run's next step. `capture_s` is
    the capture's wall time, `pool_bytes` the device memory the graph's
    pool reserved, and `launches` each counted kernel's launches in one
    replay (the counters see the capture launch nothing, and each replay
    launch them all)."""

    def __init__(self, state: TrainState, body,
                 example: Dict[str, torch.Tensor]):
        self.inputs = {n: v.clone() for n, v in example.items()}
        # The warm-up and the capture run on one side stream, the stream
        # autograd then records for the parameters' gradient
        # accumulators (a capture must not touch the default stream).
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with torch.no_grad():
                snapshot = [t.detach().clone()
                            for t in _state_tensors(state)]
            for _ in range(_WARMUP_STEPS):
                body(self.inputs)
            with torch.no_grad():
                for t, saved in zip(_state_tensors(state), snapshot):
                    t.copy_(saved)
            del snapshot, saved
        torch.cuda.synchronize()
        # The capture empties the allocator's cache first; emptied here,
        # the reserved memory grows by the graph's pool alone.
        torch.cuda.empty_cache()
        before = tuple(fn.launches for fn in _launch_counters())
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # Thread-local: the loop's prefetch thread pins the next payloads
        # while this thread captures, and pinning queries CUDA events
        # (the host allocator's), which in the default global mode
        # invalidates a capture running on any thread.
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.metrics = body(self.inputs)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.launches = tuple(fn.launches - b for fn, b
                              in zip(_launch_counters(), before))
        _add_launches([-n for n in self.launches])
        logger.info("Captured the train step as a CUDA graph in %.2f s "
                    "(pool %.1f MiB, kernel launches a step %s)",
                    self.capture_s, self.pool_bytes / 2**20, self.launches)

    def replay(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        for name, static in self.inputs.items():
            static.copy_(inputs[name])
        self.graph.replay()
        _add_launches(self.launches)
        return self.metrics


def make_train_multi(cfg: ModelConfig, remat: bool = False,
                     grad_accum: int = 1, dp: Optional[DataParallel] = None):
    """K optimizer steps per dispatch.

    Signature: multi(state, batches, iter0, seed, k_real=None)
      -> (state, metrics)
    as the JAX package's, with the base sampling seed in place of its
    key: `batches` is (images (K,T,B,...), actions (K,T,B,A), states
    (K,T,B,S)) or a StagedCall of them (see stage_call); step k draws
    its sampling inputs from `sampling.generator(seed, iter0 + k)`, the
    one-step path's generator at that absolute iteration, so a run's
    trajectory does not depend on K or on where it resumed. Only the
    first `k_real` steps run (default K), so a run's last, short
    dispatch needs no padding; `metrics` holds the (K,) losses and
    PSNRs, NaN past `k_real`.

    On a GPU the payload reaches the device in one copy, and one step,
    captured once as a CUDA graph (CapturedStep, on `multi.captured`
    after the first call), is replayed for each step: no host sync
    inside the dispatch. A capture or replay that fails raises. On the
    CPU the same staged steps run eagerly.

    With `dp` (see make_train_step) the graph captures the gradient
    all-reduce too, which NCCL allows once its communicator is warm (the
    eager warm-up steps all-reduce first). gloo's collectives cannot be
    captured, so on a GPU a gloo group raises."""
    _check_dp(dp, grad_accum)

    def body(state, inputs):
        batch = (inputs["images"], inputs["actions"], inputs["states"])
        grads, metrics = _grads(state.params, cfg, batch,
                                inputs.get("uniforms"),
                                inputs.get("n_gt", 0), remat, grad_accum,
                                dp)
        _apply(state, grads)
        return torch.stack([metrics["loss"], metrics["psnr_all"]])

    def captured_for(state, example) -> CapturedStep:
        spec = (id(state),) + tuple((n, v.shape, v.dtype)
                                    for n, v in example.items())
        if multi.captured is None or multi.spec != spec:
            if not isinstance(state.optimizer, ChainerAdam):
                raise TypeError("a captured train step needs ChainerAdam, "
                                f"got {type(state.optimizer).__name__}")
            state.optimizer.init_state()
            multi.captured = None
            multi.captured = CapturedStep(
                state, lambda inputs: body(state, inputs), example)
            multi.spec = spec
        return multi.captured

    def multi(state: TrainState, batches: Union[StagedCall, tuple],
              iter0: int, seed: int, k_real: Optional[int] = None):
        device = state.leaves()[0].device
        staged = batches
        if not isinstance(staged, StagedCall):
            staged = stage_call(cfg, batches, iter0, seed, grad_accum,
                                pin=device.type == "cuda", dp=dp)
        if (staged.iter0, staged.seed) != (iter0, seed):
            raise ValueError(
                f"the call was staged for iteration {staged.iter0}, seed "
                f"{staged.seed}, not {iter0}, {seed}")
        k_real = staged.k if k_real is None else int(k_real)
        if not 1 <= k_real <= staged.k:
            raise ValueError(f"k_real {k_real} outside 1..{staged.k}")
        if device.type == "cuda":
            if dp is not None and dp.backend != "nccl":
                raise RuntimeError(
                    f"a CUDA graph of the train step cannot capture "
                    f"{dp.backend}'s all-reduce: use NCCL (a GPU per "
                    f"rank) or --steps_per_call 1")
            host = staged.buffer
            if not host.is_pinned():
                host = host.pin_memory()
            views = staged.views(host.to(device, non_blocking=True))
            step = captured_for(state, {n: v[0] for n, v in views.items()})
            out = torch.full((staged.k, 2), float("nan"), device=device,
                             dtype=step.metrics.dtype)
            for i in range(k_real):
                out[i].copy_(step.replay({n: v[i]
                                          for n, v in views.items()}))
        else:
            views = staged.views()
            rows = [body(state, {n: v[i] for n, v in views.items()})
                    for i in range(k_real)]
            out = torch.cat([torch.stack(rows), rows[0].new_full(
                (staged.k - k_real, 2), float("nan"))])
        state.step += k_real
        return state, {"loss": out[:, 0], "psnr_all": out[:, 1]}

    multi.captured = None
    multi.spec = None
    return multi


def make_eval_step(cfg: ModelConfig,
                   keys: Optional[Tuple[str, ...]] = _EVAL_METRIC_KEYS):
    """Validation step: the feed-self rollout (train=False) under
    no_grad, returning the selected rollout keys (default: the
    validation metric matrices; keys=None for the full dict)."""

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        images, actions, states = batch
        return predictor.rollout(params, cfg, images, actions, states,
                                 train=False, keys=keys)

    return eval_step
