"""Command-line pieces shared by ``cli.train`` and ``cli.evaluate``: the
flags the port adds in front of the JAX package's parser, and the model of a
run."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from hands_tpu_torch.config import Config, construct_args


def _pop(argv: List[str], flag: str, default):
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{flag} needs a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def parse(argv: Optional[List[str]]) -> Tuple[Config, str]:
    """(config, device). ``--device`` (default ``cuda``) and ``--dataset``
    (the training dataset, e.g. ``synthetic``) are taken off ``argv``; the
    rest goes to ``construct_args``, the JAX package's flags. ``--eval_on``
    names the validation dataset. ``--debug`` and ``-f`` choose the synthetic
    datasets and turn the mask loss off, as in the JAX package, and win over
    ``--eval_on`` and ``--dataset``: the order of
    ``hands_tpu/cli/evaluate.py``, ``--eval_on`` first. (``hands_tpu``'s
    ``cli.train`` reads no ``--eval_on``; the port's does, so that a run on
    ``--dataset synthetic`` can name its validation set.)"""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop(argv, "--device", "cuda")
    dataset = _pop(argv, "--dataset", None)
    cfg = construct_args(argv)
    if cfg.num_processes > 1:
        raise NotImplementedError(
            "multi-process runs are not ported: ROADMAP queue 1 item 11")
    if dataset:
        cfg = cfg.replace(dataset=dataset)
    if cfg.eval_on:
        cfg = cfg.replace(val_dataset=cfg.eval_on)
    if cfg.debug or cfg.fast_dev_run:
        cfg = cfg.replace(dataset="synthetic", val_dataset="synthetic",
                          use_render_seg_loss=False)
    return cfg, device


def build_model(cfg: Config, device):
    """The model of ``cfg`` on ``device`` with f32 master parameters (what a
    train state takes; a bf16 HaMeR casts them per call)."""
    from hands_tpu_torch.models.registry import fetch_model

    return fetch_model(cfg, device=device, seed=cfg.seed,
                       param_dtype=torch.float32)
