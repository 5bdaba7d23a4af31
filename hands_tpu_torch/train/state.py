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

Under FSDP (``parallel/fsdp.py``) the optimiser holds each rank's shard of a
sharded parameter, and the moments and the accumulated gradient are made from
it, so they are sharded alike; the clip's norm sums the shards' squares over
the ranks (one all-reduce), so every rank clips by the norm of the whole
gradient. A parameter that tensor parallelism shards over the model ranks
(``parallel/sharding.py``) is held and updated as its shard likewise, and
its squares are summed over its model group.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional, Sequence

import torch
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.parallel import fsdp
from hands_tpu_torch.parallel.mesh import DataGroup, all_reduce_sum
from hands_tpu_torch.parallel.sharding import tp_shard_of

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def global_norm(grads: List[torch.Tensor], sharded: Sequence[bool] = (),
                dp: Optional[DataGroup] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, in f32. ``sharded[i]``
    marks a gradient that is this rank's shard of one sharded over the ranks
    of ``dp``: its squares are summed over the ranks."""
    if dp is None or not any(sharded):
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = []
    for part in (True, False):
        gs = [g.float() for g, s in zip(grads, sharded) if s == part]
        squares.append(torch.stack(torch._foreach_norm(gs)).square().sum()
                       if gs else grads[0].new_zeros((), dtype=torch.float32))
    shards = all_reduce_sum(squares[0].reshape(1), dp)[0]
    return torch.sqrt(shards + squares[1])


class Optimizer:
    """Clip -> Adam under a schedule, with gradient accumulation. Holds the
    f32 moments, the accumulated gradient, and the two counters."""

    def __init__(self, cfg: Config, params: List[torch.Tensor],
                 steps_per_epoch: int = 1000,
                 dp: Optional[DataGroup] = None):
        self.lr = cfg.lr
        self.clip = cfg.grad_clip
        self.acc_grad = max(int(cfg.acc_grad), 1)
        self.boundaries = sorted(int(e) * steps_per_epoch
                                 for e in cfg.lr_dec_epoch)
        self.factor = 1.0 / cfg.lr_dec_factor
        # the model's parameters, sharded ones as FSDP holds them; the update
        # reads and writes :attr:`params`
        self.model_params = params
        # the gradients that are shards, and the group whose ranks hold the
        # other shards: FSDP's over the data ranks, or tensor parallelism's
        # over the model ranks (the two together are refused)
        self.sharded = [fsdp.is_sharded(p) for p in params]
        self.dp = dp
        tp = [tp_shard_of(p) for p in params]
        if any(t is not None for t in tp):
            self.sharded = [t is not None for t in tp]
            self.dp = next(t.tp for t in tp if t is not None)
        params = self.params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.acc = ([torch.zeros_like(p) for p in params]
                    if self.acc_grad > 1 else None)
        self.count = 0  # Adam updates made
        self.mini_step = 0  # micro-batches since the last update

    @property
    def params(self) -> List[torch.Tensor]:
        """This rank's shard of each sharded parameter, else the parameter.
        Taken anew at every call: FSDP moves a shard's storage when it
        first runs, so an alias kept from before would go stale."""
        return [fsdp.local(p) for p in self.model_params]

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
        norm = self.grad_norm(grads)
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

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads``, laid out as :attr:`params`."""
        return global_norm(grads, self.sharded, self.dp)


def make_optimizer(cfg: Config, params: List[torch.Tensor],
                   steps_per_epoch: int = 1000,
                   dp: Optional[DataGroup] = None) -> Optimizer:
    return Optimizer(cfg, params, steps_per_epoch, dp)


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
                       steps_per_epoch: int = 1000,
                       dp: Optional[DataGroup] = None) -> TrainState:
    """Train state over every parameter of ``model`` (after FSDP has sharded
    it, where it does; ``dp`` is then the ranks it is sharded over). The
    parameters must be f32 (Adam updates f32 masters; a bf16 HaMeR is built
    with ``param_dtype=torch.float32``)."""
    named = list(model.named_parameters())
    low = [n for n, p in named if p.dtype != torch.float32]
    if low:
        raise ValueError(
            f"{len(low)} parameters are not float32 (first: {low[0]}): build "
            f"the model with param_dtype=torch.float32 to train it")
    return TrainState(model, make_optimizer(cfg, [p for _, p in named],
                                            steps_per_epoch, dp))
