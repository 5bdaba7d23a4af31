"""Train state and optimiser (port of ``hands_tpu/train/state.py``).

The optimiser is the JAX package's chain written out: global-norm gradient
clipping at ``cfg.grad_clip``, Adam at ``cfg.lr`` with a piecewise-constant
schedule (divide by ``lr_dec_factor`` at each ``lr_dec_epoch`` boundary), and
gradient accumulation over ``cfg.acc_grad`` micro-batches.

- The clip scales by ``clip / norm`` only when ``norm >= clip``; nothing is
  added to the norm.
- Adam: b1 0.9, b2 0.999, eps 1e-8 added outside the root, bias correction
  by the count of updates; the learning rate is the schedule at the count
  before the update.
- Accumulation keeps the running mean of the micro-batch gradients, clips
  that mean, and on the steps between leaves parameters, moments and the
  update count untouched.

Parameters are updated in place (the model's own ``nn.Parameter``s; JAX
donates the old state instead), with fused ``torch._foreach`` arithmetic.
No value is read back to the host.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional

import torch
from torch import nn

from hands_tpu_torch.config import Config

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, in f32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Clip -> Adam under a schedule, with gradient accumulation. Holds the
    f32 moments, the accumulated gradient, and the two counters."""

    def __init__(self, cfg: Config, params: List[torch.Tensor],
                 steps_per_epoch: int = 1000):
        self.lr = cfg.lr
        self.clip = cfg.grad_clip
        self.acc_grad = max(int(cfg.acc_grad), 1)
        self.boundaries = sorted(int(e) * steps_per_epoch
                                 for e in cfg.lr_dec_epoch)
        self.factor = 1.0 / cfg.lr_dec_factor
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.acc = ([torch.zeros_like(p) for p in params]
                    if self.acc_grad > 1 else None)
        self.count = 0  # Adam updates made
        self.mini_step = 0  # micro-batches since the last update

    def learning_rate(self, count: Optional[int] = None) -> float:
        """The schedule at ``count`` updates (default: now): ``lr`` times
        ``1 / lr_dec_factor`` for every boundary reached."""
        count = self.count if count is None else count
        return self.lr * self.factor ** bisect_right(self.boundaries, count)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """One micro-step: accumulate, and on every ``acc_grad``-th call clip
        and apply Adam to the parameters in place."""
        if self.acc is not None:
            # running mean: acc += (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_add_(self.acc, diff,
                                alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.acc_grad:
                return
            grads = self.acc
        # (g / norm) * clip where norm >= clip, else (g / 1) * 1 = g
        norm = global_norm(grads)
        one = torch.ones_like(norm)
        under = norm < self.clip
        grads = torch._foreach_div(grads, torch.where(under, one, norm))
        torch._foreach_mul_(grads, torch.where(under, one, one * self.clip))
        lr = self.learning_rate()
        self.count += 1
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - _B2)
        c1 = 1.0 - _B1 ** self.count
        c2 = 1.0 - _B2 ** self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / c1)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0


def make_optimizer(cfg: Config, params: List[torch.Tensor],
                   steps_per_epoch: int = 1000) -> Optimizer:
    return Optimizer(cfg, params, steps_per_epoch)


class TrainState:
    """The model (parameters and BatchNorm running statistics live in it),
    its optimiser and the count of micro-steps taken."""

    def __init__(self, model: nn.Module, tx: Optimizer):
        self.model = model
        self.tx = tx
        self.step = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return self.tx.params

    def apply_gradients(self, grads: List[torch.Tensor]) -> "TrainState":
        self.tx.update(grads)
        self.step += 1
        return self


def create_train_state(cfg: Config, model: nn.Module,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Train state over every parameter of ``model``. The parameters must be
    f32 (Adam updates f32 masters; a bf16 HaMeR is built with
    ``param_dtype=torch.float32``)."""
    named = list(model.named_parameters())
    low = [n for n, p in named if p.dtype != torch.float32]
    if low:
        raise ValueError(
            f"{len(low)} parameters are not float32 (first: {low[0]}): build "
            f"the model with param_dtype=torch.float32 to train it")
    return TrainState(model, make_optimizer(cfg, [p for _, p in named],
                                            steps_per_epoch))
