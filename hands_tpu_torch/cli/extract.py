"""Feature extraction (port of ``hands_tpu/cli/extract.py``, the reference's
``mode='extract'`` path): run the model over the validation split and dump
one file a sequence (image names, ``feat_vec`` and the selected MANO
predictions).

    python -m hands_tpu_torch.cli.extract --infer_ckpt \\
        logs/<key>/checkpoints/last [--eval_on synthetic] [--device cuda]

Writes ``logs/<exp_key or extract>/eval/<seq>.npy``, a pickled dict with
``imgname`` and ``pred.<key>`` arrays, one row a real image of the sequence
(a sequence is the image name's directory). ``--debug`` extracts the
synthetic split; ``--infer_ckpt`` loads the model's parameters and running
statistics from a checkpoint of ``cli.train``. It runs on the card unless
``--device cpu`` is given; ``cli.build_feat_split`` packs the files.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

KEEP_KEYS = ("feat_vec", "mano.cam_t.r", "mano.cam_t.l", "mano.beta.r",
             "mano.beta.l")


def main(argv=None, overrides=None) -> str:
    import numpy as np
    import torch

    from hands_tpu_torch.cli._args import build_model, parse
    from hands_tpu_torch.data.factory import fetch_dataloader
    from hands_tpu_torch.train.checkpoint import CheckpointManager

    cfg, device = parse(argv)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg, device)
    loader = fetch_dataloader(cfg, "val", device=device)
    if cfg.infer_ckpt:
        ckpt = CheckpointManager(os.path.dirname(cfg.infer_ckpt))
        ckpt.restore_params(model, os.path.basename(cfg.infer_ckpt))

    per_seq = defaultdict(lambda: defaultdict(list))
    for inputs, _, meta in loader:
        names = meta["imgname"]
        with torch.inference_mode():
            pred = model(inputs, meta)
        rows = {}
        for k in KEEP_KEYS:
            if k in pred:
                t = pred[k][:len(names)]
                if t.dtype == torch.bfloat16:  # numpy has no bf16
                    t = t.float()
                rows[k] = t.cpu().numpy()
        for i, imgname in enumerate(names):
            seq = "/".join(imgname.split("/")[:-1]) or "seq"
            per_seq[seq]["imgname"].append(imgname)
            for k, v in rows.items():
                per_seq[seq][f"pred.{k}"].append(v[i])

    out_dir = os.path.join("logs", cfg.exp_key or "extract", "eval")
    os.makedirs(out_dir, exist_ok=True)
    for seq, data in per_seq.items():
        payload = {k: (np.stack(v) if isinstance(v[0], np.ndarray) else v)
                   for k, v in data.items()}
        name = seq.replace("/", "__") + ".npy"
        np.save(os.path.join(out_dir, name), payload)
    print(f"extracted {len(per_seq)} sequences -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main(sys.argv[1:])
