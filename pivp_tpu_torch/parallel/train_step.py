"""Train and eval steps on one device.

Counterpart of `pivp_tpu/parallel/train_step.py` without the mesh: one
step is the scheduled-sampling rollout, its backward (through the
kernels' autograd Functions) and a Chainer-exact Adam update, in place on
the parameter tensors. Metrics stay device tensors, so no step waits on
the device; the training loop reads them at the epoch flush.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.utils import weights

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
    parameter's state holds `count`, `mu` and `nu`."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainerAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                g, mu, nu = p.grad, st["mu"], st["nu"]
                mu.add_(g - mu, alpha=1.0 - b1)
                nu.add_(g * g - nu, alpha=1.0 - b2)
                t = st["count"]
                alpha_t = (group["lr"] * math.sqrt(1.0 - b2 ** t)
                           / (1.0 - b1 ** t))
                p.addcdiv_(mu, nu.sqrt().add_(group["eps"]), value=-alpha_t)


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
        count = max(count, st.get("count", 0))
        mu[key] = st["mu"].detach() if "mu" in st else torch.zeros_like(p)
        nu[key] = st["nu"].detach() if "nu" in st else torch.zeros_like(p)
    return {"count": torch.tensor(count, dtype=torch.int32),
            "mu": weights.unflatten(mu), "nu": weights.unflatten(nu)}


def load_opt_state_tree(state: TrainState, tree: Dict) -> None:
    """Restore a ChainerAdamState tree (see opt_state_tree) into the
    optimizer, on each parameter's device and dtype."""
    count = int(tree["count"])
    mu, nu = weights.flatten(tree["mu"]), weights.flatten(tree["nu"])
    for key, p in weights.flatten(state.params).items():
        state.optimizer.state[p] = {
            "count": count,
            "mu": mu[key].to(device=p.device, dtype=p.dtype).clone(),
            "nu": nu[key].to(device=p.device, dtype=p.dtype).clone()}


def _loss_fn(params, cfg: ModelConfig, batch: Batch, iter_num: int,
             generator: torch.Generator, remat: bool):
    images, actions, states = batch
    out = predictor.rollout(params, cfg, images, actions, states,
                            train=True, iter_num=iter_num,
                            generator=generator, remat=remat,
                            keys=_METRIC_KEYS)
    return out["loss"], out


def grads_and_metrics(params, cfg: ModelConfig, batch: Batch,
                      iter_num: int, generator: torch.Generator,
                      remat: bool = False, grad_accum: int = 1
                      ) -> Tuple[List[torch.Tensor], Dict]:
    """Gradients (in `weights.flatten(params)` order) and detached
    metrics, optionally over `grad_accum` contiguous microbatches. The
    loss is a batch mean, so the mean of the microbatch gradients is
    exact; metrics become means of the per-microbatch values.
    Microbatch g draws its uniforms from a generator folded from the
    step's seed and g, as the JAX package folds its key."""
    leaves = list(weights.flatten(params).values())
    if grad_accum <= 1:
        loss, out = _loss_fn(params, cfg, batch, iter_num, generator, remat)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in out.items()}

    b = batch[0].shape[1]
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum "
                         f"{grad_accum}")
    mb = b // grad_accum
    seed = generator.initial_seed()
    g_sum: Optional[List[torch.Tensor]] = None
    m_sum: Dict[str, torch.Tensor] = {}
    for g in range(grad_accum):
        micro = tuple(a[:, g * mb:(g + 1) * mb] for a in batch)
        loss, out = _loss_fn(params, cfg, micro, iter_num,
                             sampling.generator(seed, g), remat)
        grads = torch.autograd.grad(loss, leaves)
        g_sum = (list(grads) if g_sum is None
                 else [a + d for a, d in zip(g_sum, grads)])
        for k, v in out.items():
            m_sum[k] = m_sum[k] + v.detach() if k in m_sum else v.detach()
    inv = 1.0 / grad_accum
    return ([x * inv for x in g_sum],
            {k: v * inv for k, v in m_sum.items()})


def make_train_step(cfg: ModelConfig, remat: bool = False,
                    grad_accum: int = 1):
    """Build step(state, (images, actions, states), iter_num, generator)
    -> (state, metrics). Batches are time-major (T, B, ...) on the
    parameters' device; the update is in place and `state.step` counts
    it. `generator` (a CPU torch.Generator) draws the scheduled-sampling
    uniforms."""

    def train_step(state: TrainState, batch: Batch, iter_num: int,
                   generator: torch.Generator):
        grads, metrics = grads_and_metrics(
            state.params, cfg, batch, iter_num, generator, remat,
            grad_accum)
        for p, g in zip(state.leaves(), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return train_step


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
