"""The training and evaluation loop (port of ``hands_tpu/train/trainer.py``,
one process on one card).

Kept from the JAX loop: running-window means of the *unweighted* loss terms
logged every ``log_every`` steps with the ``__train`` postfix; the non-finite
loss check under ``--debug``; ``save_every_steps``; validation every
``eval_every_epoch`` epochs with the per-image metric arrays concatenated and
``nanmean``-ed (padded tail rows are NaN) under ``metric.`` / ``__val`` names;
checkpoint selection on the lowest ``loss__val`` (top 3 plus ``last``); one
sanity validation batch before training; resume (``resume_ckpt``: optimiser,
step and epoch), warm start (``load_ckpt``: parameters only) and pretrained
backbones (``load_backbone``: a ``cli.convert_ckpt`` file); ``profile_steps``;
the overlays of one validation batch after each validation (``visualize``).

Different by construction: the model is an ``nn.Module`` that holds its
weights, so ``fit`` initialises nothing; the steps switch the module between
train and eval mode themselves; the loss terms of a window stay on the card
and are read back once per window (one host synchronisation per ``log_every``
steps, not one per term and step); dropout draws from a generator seeded from
``cfg.seed``.

Over several processes (``cli.train --num_processes``, the group brought up
by ``parallel.distributed.initialize_from_config``) each rank's loader hands
it its rows of every global batch (``shard``), the steps reduce over the
ranks (``train/step.py``), and the step equals the one-process step on the
global batch. Before the state is made the model is placed once
(:meth:`place_model`): rank 0's values go to every rank, and with ``fsdp``
the model is sharded (``parallel/fsdp.py``); otherwise its parameters stay
replicated, as DDP keeps them. With one process ``fsdp`` changes nothing, as
in JAX on one device. Rank 0 alone logs and writes checkpoints; validation
gathers the metric rows of every rank, so each means the same arrays; the
overlays are drawn by one-process runs only, as in JAX. Only the data axis is
ported: a ``mesh_axis_names`` with another axis raises (ROADMAP queue 1 item
11).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.precision import f32_exact
from hands_tpu_torch.core.xdict import XDict, device_view
from hands_tpu_torch.parallel import mesh as mesh_lib
from hands_tpu_torch.parallel.distributed import (data_group, gather_to_host,
                                                  process_index)
from hands_tpu_torch.parallel.fsdp import shard_model
from hands_tpu_torch.parallel.mesh import check_data_axes, make_mesh
from hands_tpu_torch.train.checkpoint import (CheckpointManager,
                                              graft_backbone_variables)
from hands_tpu_torch.train.process import process_data_light
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.train.step import make_eval_step, make_train_step
from hands_tpu_torch.utils.experiment import Experiment


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg: Config, model,
                 experiment: Optional[Experiment] = None):
        check_data_axes(cfg.mesh_shape, cfg.mesh_axis_names)
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.exp = experiment or Experiment(cfg)
        self.ckpt = CheckpointManager(self.exp.ckpt_dir)
        # the data ranks (None for one process) and, with fsdp, their mesh
        self.dp = data_group()
        self.fsdp = bool(cfg.get("fsdp", False)) and self.dp is not None
        self.mesh = (make_mesh(cfg.mesh_shape, cfg.mesh_axis_names,
                               self.device.type)
                     if self.dp is not None else None)
        self._placed = False
        self.train_step = make_train_step(model, cfg, self.dp)
        metric_specs = (
            ["pix_err"] if cfg.val_dataset == "epic"
            else ["mrrpe.rl", "mpjpe.ra", "mpjpe.pa.ra", "pix_err"])
        self.eval_step = make_eval_step(model, cfg, metric_specs, self.dp)
        # host seconds of the last fit: the whole loop, and the part of it
        # spent waiting for the loader's next batch
        self.timing = {"steps": 0, "loop_s": 0.0, "data_s": 0.0}

    # ---------------------------------------------------------- placement
    def place_model(self) -> None:
        """Once, before the train state is made: rank 0's parameters and
        buffers to every rank, then FSDP's sharding under ``fsdp``. Nothing
        for one process."""
        if self.dp is None or self._placed:
            return
        mesh_lib.broadcast_(list(self.model.parameters())
                            + list(self.model.buffers()), self.dp)
        if self.fsdp:
            shard_model(self.model, self.mesh)
        self._placed = True

    def _check_loader(self, loader) -> None:
        want = (0, 1) if self.dp is None else (self.dp.rank, self.dp.world)
        have = tuple(getattr(loader, "shard", want))
        if have != want:
            raise ValueError(f"loader shard {have}, but this is rank "
                             f"{want[0]} of {want[1]}")

    def init_state(self, steps_per_epoch: int = 1000):
        """The train state of ``fit``: backbone graft or warm start, the
        model's placement, the state, and the resume. Returns (state, the
        epoch to start from)."""
        cfg = self.cfg
        if cfg.get("load_backbone", ""):
            # pretrained backbones from a cli.convert_ckpt file (the
            # reference's load_state_dict of released weights)
            grafted = graft_backbone_variables(self.model, torch.load(
                cfg.load_backbone, map_location=self.device,
                weights_only=True))
            print(f"grafted pretrained backbone from {cfg.load_backbone} "
                  f"into {', '.join(grafted)}")
        resume = bool(cfg.resume_ckpt) and self.ckpt.has_checkpoint("last")
        if cfg.load_ckpt and not resume:
            warm = CheckpointManager(os.path.dirname(cfg.load_ckpt))
            warm.restore_params(self.model, os.path.basename(cfg.load_ckpt))
        self.place_model()
        state = create_train_state(cfg, self.model,
                                   steps_per_epoch=steps_per_epoch,
                                   dp=self.dp)
        start_epoch = 0
        if resume:
            state, start_epoch = self.ckpt.restore(state, "last")
            print(f"resumed from epoch {start_epoch}")
        return state, start_epoch

    # ------------------------------------------------------------------ fit
    def fit(self, train_loader, val_loader=None,
            num_epochs: Optional[int] = None):
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epoch
        for loader in (train_loader, val_loader):
            if loader is not None:
                self._check_loader(loader)
        state, start_epoch = self.init_state(len(train_loader))

        # one sanity val batch before training
        if val_loader is not None:
            self._sanity_val(state, val_loader)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        global_step = int(state.step)
        window = defaultdict(list)  # loss terms of this window, on the card
        tracer = None
        if cfg.get("profile_steps", 0) and process_index() == 0:
            from hands_tpu_torch.utils.profiling import StepTrace

            tracer = StepTrace(os.path.join(self.exp.dir, "trace"),
                               cfg.profile_steps)
        step_in_run = 0
        self.timing = {"steps": 0, "loop_s": 0.0, "data_s": 0.0}
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            batches = iter(train_loader)
            while True:
                t_data = time.perf_counter()
                batch = next(batches, None)
                self.timing["data_s"] += time.perf_counter() - t_data
                if batch is None:
                    break
                if tracer is not None:
                    tracer.update(step_in_run)
                inputs, targets, meta = batch
                state, logs = self.train_step(
                    state, (inputs, targets, device_view(meta)), gen)
                global_step += 1
                step_in_run += 1
                for k, v in logs.items():
                    window[k].append(v)
                if cfg.debug and not bool(torch.isfinite(logs["loss"])):
                    # fail fast under --debug (this check waits for the card;
                    # NaN-masked metric arrays are exempt by construction)
                    raise FloatingPointError(
                        f"non-finite loss at step {global_step}")
                if global_step % cfg.log_every == 0:
                    self.exp.log_dict(self._window_means(window), global_step,
                                      postfix="__train")
                    window.clear()
                if cfg.save_every_steps and \
                        global_step % cfg.save_every_steps == 0:
                    # mid-epoch checkpoint (resume replays the rest of the
                    # epoch; the step counter is restored exactly)
                    self.ckpt.save_last(state, epoch)

            _sync(self.device)
            epoch_time = time.time() - t0
            self.timing["loop_s"] += epoch_time
            self.timing["steps"] = step_in_run
            self.exp.log_dict({"epoch_time_s": epoch_time}, global_step)

            if val_loader is not None and \
                    (epoch + 1) % cfg.eval_every_epoch == 0:
                val_metrics = self.validate(state, val_loader)
                self.exp.log_dict(val_metrics, global_step, postfix="__val")
                self.ckpt.save_top_k(state, epoch, val_metrics["loss"])
                if not cfg.no_vis and self.dp is None:
                    self.visualize(state, val_loader, global_step)
            self.ckpt.save_last(state, epoch + 1)
        if tracer is not None:
            tracer.close()
        return state

    @staticmethod
    def _window_means(window) -> dict:
        """Means of the window's loss terms, read back in one transfer."""
        keys = list(window)
        stacked = torch.stack([
            torch.stack([v.detach().double() for v in window[k]]).mean()
            for k in keys])
        return dict(zip(keys, stacked.tolist()))

    # ------------------------------------------------------------ visualise
    def visualize(self, state, loader, step: int, max_examples: int = 1):
        """Keypoint and mesh overlays of one batch, pushed to the experiment;
        returns the [(name, image)] list ([] if drawing failed). The ground
        truth's FK keys come from ``process_data_light`` and the prediction
        from the eval forward (both launch kernels on the card); only the
        drawing is allowed to fail."""
        from hands_tpu_torch.utils.vis import visualize_all

        inputs, targets, meta = next(iter(loader))
        meta_dev = device_view(meta)
        # the GT render panel needs the GT's v3d/j3d.cam keys
        inputs, targets, meta_dev = process_data_light(
            self.model.mano_r.model, self.model.mano_l.model, inputs,
            targets, meta_dev, self.cfg.img_res)
        self.model.eval()
        with torch.no_grad(), f32_exact():
            pred = self.model(inputs, meta_dev)
        vis_dict = XDict()
        vis_dict.merge(XDict(inputs).prefix("inputs."))
        vis_dict.merge(XDict(pred).prefix("pred."))
        vis_dict.merge(XDict(targets).prefix("targets."))
        vis_dict.merge(XDict(meta_dev).prefix("meta_info."))
        try:
            images = visualize_all(vis_dict, self.cfg, max_examples)
            self.exp.push_images(images, step)
        except Exception as e:  # vis must never kill a training run
            print(f"visualization failed (non-fatal): {e}")
            images = []
        return images

    # ------------------------------------------------------------- validate
    def _sanity_val(self, state, val_loader):
        inputs, targets, meta = next(iter(val_loader))
        self.eval_step(state, (inputs, targets, device_view(meta)))

    def validate(self, state, val_loader) -> dict:
        """Eval epoch: ``nanmean`` of the concatenated per-image metric
        arrays and the mean of the per-batch losses. The model runs in eval
        mode (running statistics, no dropout) and is left there. Over
        several ranks every rank gathers the metric rows of all, so each
        means the same arrays (the losses are global already)."""
        metric_arrays = defaultdict(list)
        losses = defaultdict(list)
        for inputs, targets, meta in val_loader:
            metrics, logs = self.eval_step(
                state, (inputs, targets, device_view(meta)))
            metrics = gather_to_host(dict(metrics))
            for k, v in metrics.items():
                metric_arrays[k].append(v)
            for k, v in logs.items():
                losses[k].append(v)
        out = {}
        for k, arrs in metric_arrays.items():
            out["metric." + k] = float(np.nanmean(
                torch.cat(arrs, dim=0).float().cpu().numpy()))
        for k, vals in losses.items():
            out[k] = float(np.mean(torch.stack(vals).cpu().tolist()))
        return out
