"""Checkpointing with the JAX package's selection semantics (port of
``hands_tpu/train/checkpoint.py``): checkpoints live under
``logs/<exp_key>/checkpoints``; ``last`` is always written; the three best by
``loss__val`` are kept as ``epoch_%04d`` with their scores in
``scores.json``.

A checkpoint is one ``torch.save`` file of plain containers and tensors
(loaded with ``weights_only=True``): the micro-step count, the model's
``state_dict`` (parameters and running statistics), the optimiser's moments
``mu`` and ``nu``, its accumulated gradient ``acc``, its counters ``count``
and ``mini_step``, and the epoch. ``torch.save`` serialises at the call, so a
later in-place optimiser step cannot reach a saved file. ``restore`` copies
into the live tensors: the model's parameters are the optimiser's, the
schedule reads ``count`` and the accumulation ``mini_step``.

``graft_backbone_variables`` read a converted orbax directory in the JAX
package; the converter falls away in the port (ROADMAP queue 1), so
``--load_backbone`` raises (item 6).
"""

from __future__ import annotations

import json
import os
from typing import List

import torch

from hands_tpu_torch.train.state import TrainState


class CheckpointManager:
    def __init__(self, ckpt_dir: str, top_k: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.top_k = top_k
        self._scores_path = os.path.join(self.ckpt_dir, "scores.json")
        self._scores = {}
        if os.path.exists(self._scores_path):
            with open(self._scores_path) as f:
                self._scores = json.load(f)

    # ------------------------------------------------------------------ save
    @staticmethod
    def _state_payload(state: TrainState, epoch: int) -> dict:
        tx = state.tx
        return {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "opt": {"mu": list(tx.mu), "nu": list(tx.nu),
                    "acc": None if tx.acc is None else list(tx.acc),
                    "count": int(tx.count), "mini_step": int(tx.mini_step)},
            "epoch": int(epoch),
        }

    def _save(self, name: str, state: TrainState, epoch: int) -> None:
        path = os.path.join(self.ckpt_dir, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(self._state_payload(state, epoch), tmp)
        os.replace(tmp, path)  # a reader never sees half a file

    def save_last(self, state: TrainState, epoch: int) -> None:
        self._save("last", state, epoch)

    def save_top_k(self, state: TrainState, epoch: int,
                   monitor_value: float) -> None:
        """Keep the ``top_k`` lowest ``loss__val`` checkpoints."""
        name = f"epoch_{epoch:04d}"
        self._scores[name] = float(monitor_value)
        keep = sorted(self._scores, key=self._scores.get)[: self.top_k]
        if name in keep:
            self._save(name, state, epoch)
        for stale in [k for k in self._scores if k not in keep]:
            del self._scores[stale]
            stale_p = os.path.join(self.ckpt_dir, stale)
            if os.path.exists(stale_p):
                os.remove(stale_p)
        with open(self._scores_path, "w") as f:
            json.dump(self._scores, f)

    # --------------------------------------------------------------- restore
    def _load(self, name: str, device) -> dict:
        return torch.load(os.path.join(self.ckpt_dir, name),
                          map_location=device, weights_only=True)

    def restore(self, state: TrainState, name: str = "last"):
        """Restore a full train state (resume) into ``state``'s live tensors.
        Returns (state, epoch)."""
        device = state.params[0].device
        saved = self._load(name, device)
        state.model.load_state_dict(saved["model"], strict=True)
        tx, opt = state.tx, saved["opt"]
        if (opt["acc"] is None) != (tx.acc is None):
            raise ValueError(
                "checkpoint and optimiser disagree on gradient accumulation "
                "(acc_grad)")
        with torch.no_grad():
            pairs = [(tx.mu, opt["mu"]), (tx.nu, opt["nu"])]
            if tx.acc is not None:
                pairs.append((tx.acc, opt["acc"]))
            for live, kept in pairs:
                if len(live) != len(kept):
                    raise ValueError("checkpoint has another parameter list")
                for dst, src in zip(live, kept):
                    dst.copy_(src)
        tx.count, tx.mini_step = int(opt["count"]), int(opt["mini_step"])
        state.step = int(saved["step"])
        return state, int(saved["epoch"])

    def restore_params(self, model: torch.nn.Module, name: str = "last"
                       ) -> List[str]:
        """Warm start: the model's parameters and running statistics only,
        tolerant of entries the checkpoint lacks or holds in another shape
        (they keep their values). Returns the names left untouched."""
        saved = self._load(name, next(model.parameters()).device)
        saved = saved.get("model", saved)
        own = model.state_dict()
        take = {k: v for k, v in saved.items()
                if k in own and own[k].shape == v.shape}
        model.load_state_dict(take, strict=False)
        return [k for k in own if k not in take]

    def has_checkpoint(self, name: str = "last") -> bool:
        return os.path.exists(os.path.join(self.ckpt_dir, name))


def load_serving_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Serve trained weights: ``path`` is a checkpoint file of ``cli.train``
    (``<dir>/last`` or ``<dir>/epoch_%04d``), split into directory and name
    for :meth:`CheckpointManager.restore_params`. Every parameter and
    running statistic of ``model`` must come from it at its own shape: a
    checkpoint of another method or width raises ``ValueError`` and leaves
    nothing at init unannounced. Entries that ``model`` lacks (a head that
    serving turns off) are ignored."""
    path = path.rstrip("/")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at '{path}'")
    left = CheckpointManager(os.path.dirname(path) or ".").restore_params(
        model, os.path.basename(path))
    if left:
        raise ValueError(
            f"checkpoint '{path}' does not fit the model: {len(left)} of its "
            f"{len(model.state_dict())} entries are missing or have another "
            f"shape there (another method or width?), e.g. {left[:4]}")
