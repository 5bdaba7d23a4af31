"""Experiment lifecycle and metric logging (port of
``hands_tpu/utils/experiment.py``): experiment directories under
``logs/<exp_key>`` (a random 9-hex key), an ``args.json`` dump, resume reusing
the key embedded in a checkpoint path, and two logging backends: JSONL metrics
(always) plus TensorBoard when ``cfg.logger == "tensorboard"`` and the package
is installed. One process writes (the port runs on one card)."""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import time
from typing import Dict, Optional

from hands_tpu_torch.config import Config


def generate_exp_key() -> str:
    """Random 9-hex experiment key."""
    return secrets.token_hex(5)[:9]


def exp_key_from_ckpt_path(ckpt_path: str) -> Optional[str]:
    """Resume reuses the experiment key of ``logs/<key>/checkpoints/...``."""
    parts = os.path.normpath(ckpt_path).split(os.sep)
    if "logs" in parts:
        i = parts.index("logs")
        if i + 1 < len(parts):
            return parts[i + 1]
    return None


class Experiment:
    def __init__(self, cfg: Config, root: str = "logs"):
        key = cfg.exp_key or exp_key_from_ckpt_path(cfg.resume_ckpt or "")
        self.key = key or generate_exp_key()
        self.dir = os.path.join(root, self.key)
        self.ckpt_dir = os.path.join(self.dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.cfg = cfg
        self._save_args(cfg)
        self._metrics_f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        if cfg.logger == "tensorboard" and not cfg.mute:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # optional backend: the JSONL log remains
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=self.dir)

    def _save_args(self, cfg: Config):
        with open(os.path.join(self.dir, "args.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    def log_dict(self, metrics: Dict[str, float], step: int,
                 postfix: str = ""):
        payload = {(k + postfix): float(v) for k, v in metrics.items()}
        payload["step"] = int(step)
        payload["time"] = time.time()
        self._metrics_f.write(json.dumps(payload) + "\n")
        self._metrics_f.flush()
        if self._tb is not None:
            for k, v in payload.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def push_images(self, images, step: int):
        """Log (name, HWC uint8 or float image) pairs."""
        if self._tb is not None:
            import numpy as np

            for name, img in images:
                self._tb.add_image(name, np.asarray(img), step,
                                   dataformats="HWC")

    def close(self):
        self._metrics_f.close()
        if self._tb is not None:
            self._tb.close()
