"""Train and eval steps (port of ``hands_tpu/train/step.py``).

One step is ground-truth processing (no gradient), the model forward, the
flag-gated losses, backward, the pre-clip gradient norm, clipping and the Adam
update. The logs stay tensors on the model's device until the caller reads
them, so a step never waits for the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.train import losses as losslib
from hands_tpu_torch.train import metrics as metriclib
from hands_tpu_torch.train.process import process_data_light
from hands_tpu_torch.train.state import TrainState, global_norm

DEFAULT_METRICS = ("mrrpe.rl", "mpjpe.ra", "mpjpe.pa.ra", "pix_err")


def forward_and_loss(model, cfg: Config, batch,
                     generator: Optional[torch.Generator] = None):
    """GT processing, model forward (in the model's current mode) and the
    losses: (total, loss_dict, pred, targets)."""
    inputs, targets, meta_info = batch
    inputs, targets, meta_info = process_data_light(
        model.mano_r.model, model.mano_l.model, inputs, targets, meta_info,
        cfg.img_res)
    pred = model(inputs, meta_info, generator=generator)
    loss_dict = losslib.compute_loss_light(pred, targets, meta_info, cfg)
    return losslib.total_loss(loss_dict), loss_dict, pred, targets


def _logs(total, loss_dict):
    logs = {k: v.detach() for k, (v, _) in loss_dict.items()}
    logs["loss"] = total.detach()
    return logs


def loss_and_grads(model, cfg: Config, params, batch,
                   generator: Optional[torch.Generator] = None):
    """The train step's forward (train mode) and backward: (total, loss_dict,
    the gradient of each of ``params``, zeros where a parameter is unused).
    Call it under ``f32_matmuls``."""
    model.train()
    total, loss_dict, _, _ = forward_and_loss(model, cfg, batch, generator)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return total, loss_dict, grads


def make_train_step(model, cfg: Config) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state, logs)``.
    ``generator`` seeds the dropout masks (WildHands; HaMeR has none). The
    state is updated in place and returned; BatchNorm's running statistics
    move inside the model."""

    @f32_matmuls  # f32 products of the backward pass stay f32 on the card
    def train_step(state: TrainState, batch, generator=None):
        total, loss_dict, grads = loss_and_grads(model, cfg, state.params,
                                                 batch, generator)
        logs = _logs(total, loss_dict)
        logs["grad_norm"] = global_norm(grads)  # before the clip
        return state.apply_gradients(grads), logs

    return train_step


def make_eval_step(model, cfg: Config, metric_specs=None) -> Callable:
    """Returns ``eval_step(state, batch) -> (metrics XDict, loss dict)``:
    forward in eval mode, the losses, the 2D keys denormalised to pixels,
    the batched metrics."""
    metric_specs = list(metric_specs or DEFAULT_METRICS)

    @torch.no_grad()
    @f32_matmuls
    def eval_step(state: TrainState, batch):
        model.eval()
        total, loss_dict, pred, targets = forward_and_loss(model, cfg, batch)
        pred, targets = XDict(pred), XDict(targets)
        for d in (pred, targets):
            for key in list(d.keys()):
                if "2d.norm" in key:
                    d[key.replace(".norm", "")] = (
                        0.5 * cfg.img_res * (d[key][..., :2] + 1))
        metrics = metriclib.evaluate_metrics(pred, targets, batch[2],
                                             metric_specs)
        return metrics, _logs(total, loss_dict)

    return eval_step
