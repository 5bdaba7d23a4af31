"""Training entry point (port of ``hands_tpu/cli/train.py``).

    python -m hands_tpu_torch.cli.train --method hands_light [flags]
    python -m hands_tpu_torch.cli.train --debug        # synthetic mini run
    python -m hands_tpu_torch.cli.train --dataset synthetic --eval_on synthetic
        --trainsplit smalltrain --valsplit smallval --no_vis

Flags are the JAX package's (``config.construct_args``) plus ``--device``
(``cuda`` unless the caller names the CPU) and ``--dataset`` (the training
dataset; ``--eval_on`` names the validation one). ``--debug`` runs one epoch
on the synthetic datasets with the mask loss off; ``--dataset synthetic``
keeps the config's losses. A real dataset or an ``a+b+c`` mix is read from
the tree under ``$DATA_DIR`` (``data/datasets.py``):

    DATA_DIR=/data python -m hands_tpu_torch.cli.train \
        --dataset arctic+assembly+epic_seg --eval_on epic

Data-parallel: one process a rank, each with ``--num_processes N
--process_id r --coordinator_address host:port`` (``--fsdp`` shards the
parameters and Adam moments); ``--batch_size`` is the global batch. See
``parallel/distributed.py`` for the backend and device of a rank.
"""

from __future__ import annotations

import sys


def main(argv=None, log_root: str = "logs", overrides=None):
    """Run training. ``log_root`` is where ``<exp_key>/`` is made;
    ``overrides`` are ``Config`` fields set from Python (tests shrink the
    model with them)."""
    from hands_tpu_torch.cli._args import build_model, parse
    from hands_tpu_torch.data.factory import fetch_dataloader
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    cfg, device = parse(argv)
    if overrides:
        cfg = cfg.replace(**overrides)
    exp = Experiment(cfg, root=log_root)
    print(f"experiment {exp.key} -> {exp.dir}")
    model = build_model(cfg, device)
    trainer = Trainer(cfg, model, exp)
    train_loader = fetch_dataloader(cfg, "train", device=device,
                                    shard=trainer.data_shard)
    val_loader = fetch_dataloader(cfg, "val", device=device,
                                  shard=trainer.data_shard)
    num_epochs = 1 if (cfg.debug or cfg.fast_dev_run) else None
    state = trainer.fit(train_loader, val_loader, num_epochs=num_epochs)
    exp.close()
    print("training done; last checkpoint at", trainer.ckpt.ckpt_dir)
    return state


if __name__ == "__main__":
    from hands_tpu_torch.parallel.distributed import shutdown

    main(sys.argv[1:])
    shutdown()
