"""Evaluation entry point (port of ``hands_tpu/cli/evaluate.py``): the batched
metric sweep over a validation split.

    python -m hands_tpu_torch.cli.evaluate --infer_ckpt
        logs/<key>/checkpoints/last [--eval_on synthetic] [--device cuda]

Prints the ``nanmean`` of every per-image metric and the mean of every loss
term as JSON. ``--infer_ckpt`` loads the model's parameters and running
statistics from a checkpoint of ``cli.train``; ``--eval_on`` names the
dataset; ``--debug`` evaluates the synthetic one with the mask loss off.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None, log_root: str = "logs", overrides=None):
    from hands_tpu_torch.cli._args import build_model, parse
    from hands_tpu_torch.data.factory import fetch_dataloader
    from hands_tpu_torch.train.checkpoint import CheckpointManager
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    cfg, device = parse(argv)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg, device)
    exp = Experiment(cfg, root=log_root)
    trainer = Trainer(cfg, model, exp)
    val_loader = fetch_dataloader(cfg, "val", device=device,
                                  shard=trainer.data_shard)
    state = create_train_state(cfg, model)
    if cfg.infer_ckpt:
        ckpt = CheckpointManager(os.path.dirname(cfg.infer_ckpt))
        ckpt.restore_params(model, os.path.basename(cfg.infer_ckpt))

    metrics = trainer.validate(state, val_loader)
    exp.close()
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    from hands_tpu_torch.parallel.distributed import shutdown

    main(sys.argv[1:])
    shutdown()
