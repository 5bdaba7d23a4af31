"""EPIC-HandKps-scale evaluation sweep (the port's version of
``scripts/epic5000_sweep.py``).

The reference's headline evaluation is EPIC-HandKps at 5,000 images. This
tool runs that loop end to end on EPIC-shaped synthetic records (320 x 427
uint8 images; the real pkl is a licensed download): the records, then
``DeviceDataLoader`` with ``drop_last=False`` (the tail batch padded with
invalid rows, which the metrics give NaN), then ``Trainer.validate``
twice, then a pass of the loader alone. ``--packed`` first packs the records
(``data/packed.pack_dataset``) under a temporary directory and sweeps from
the memmap, the decode-free serving layout; without it every record's image
is generated on the loader's fetch threads. The pack is removed afterwards.

    python -m hands_tpu_torch.cli.eval_sweep [--n 5000] [--bs 128]
        [--model hands_light] [--packed]
    python -m hands_tpu_torch.cli.eval_sweep --device cpu --n 37 --bs 16 \\
        --model hands_light --backbone resnet18

Prints the dataset build s (the pack included), both epochs' wall s (the
first includes the kernels' builds), samples/s end to end over the second,
the loader-only s, and on the card the device ms of an epoch (a third,
under ``torch.profiler``) beside the second's wall time. Every metric must
be finite, the epochs must agree to ``1e-4 * max(1, |v|)``, and the padded
tail rows of the last batch must be NaN in every metric (the real rows
finite in ``pix_err``). The last line is one JSON object. Weights are
random (seed 0): the sweep times the loop and checks its plumbing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

SEED = 0  # the weights
AGREE = 1e-4  # epochs agree to AGREE * max(1, |v|)


def _no_hook(name: str):
    return contextlib.nullcontext()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sweep_config(model: str = "hands_light", bs: int = 128, n: int = 5000,
                 **overrides):
    """The JAX tool's configuration: bf16, the test batch ``bs``, the render
    loss off; no TensorBoard. ``overrides`` go to ``default_config``."""
    from hands_tpu_torch.config import default_config

    kw = dict(compute_dtype="bfloat16", test_batch_size=bs,
              use_render_seg_loss=False, exp_key=f"epic{n}", logger="none")
    kw.update(overrides)
    return default_config(model, **kw)


def sweep(n: int = 5000, bs: int = 128, model: str = "hands_light",
          packed: bool = False, device="cuda", net=None,
          root: Optional[str] = None, hook: Callable = _no_hook,
          **overrides) -> dict:
    """Build ``n`` records (packed with ``packed``), validate them twice and
    pass the loader alone; returns the numbers of the JSON line, the
    epochs' metrics and the last batch's metric rows (``tail``). ``net``:
    the model to evaluate (default: random weights from ``SEED``);
    ``root``: where the pack and the experiment go (default: a new
    temporary directory, removed after);
    each epoch and the loader pass run inside ``hook(name)``. On the card
    a third epoch runs under ``torch.profiler`` for the device ms of an
    epoch (its wall time, the profiler's cost included, is not kept)."""
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
    from hands_tpu_torch.data.packed import PackedRecordDataset, pack_dataset
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    cfg = sweep_config(model, bs, n, **overrides)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        t0 = time.time()
        dataset = SyntheticRecordDataset(cfg, split="val", length=n)
        len(dataset)  # the labels: one MANO forward a hand for all records
        if packed:
            pdir = pack_dataset(dataset, os.path.join(tmp, "packed"))
            dataset = PackedRecordDataset(pdir)
            if len(dataset) != n:
                raise RuntimeError(f"packed {len(dataset)} records, not {n}")
        loader = DeviceDataLoader(dataset, cfg, cfg.test_batch_size,
                                  is_train=False, drop_last=False,
                                  device=device)
        t_build = time.time() - t0
        n_tail = n - (len(loader) - 1) * bs  # real rows of the last batch
        print(f"dataset: {n} EPIC-shaped records built in {t_build:.1f} s "
              f"({'packed' if packed else 'records'}; {len(loader)} batches "
              f"of {bs}, the last with {n_tail} real rows)", flush=True)

        net = net if net is not None else fetch_model(cfg, device=device,
                                                      seed=SEED)
        trainer = Trainer(cfg, net, Experiment(cfg, root=os.path.join(
            tmp, "logs")))
        # the last batch's per-row metrics, to read the padded tail
        eval_step, tail = trainer.eval_step, {}

        def recording(state, batch):
            metrics, logs = eval_step(state, batch)
            tail["metrics"] = metrics
            return metrics, logs

        trainer.eval_step = recording

        def epoch(name):
            # the eval step reads the model: no train state is made; the
            # metrics come back to the host, so the card is done at return
            t = time.time()
            with hook(name):
                metrics = trainer.validate(None, loader)
            return metrics, time.time() - t

        metrics, t_ep1 = epoch("epoch 1")
        metrics2, t_ep2 = epoch("epoch 2")
        out = {"metric": f"epic{n}_e2e_eval", "value": n / t_ep2,
               "unit": "samples/s", "epoch1_s": t_ep1, "epoch2_s": t_ep2,
               "build_s": t_build, "n": n, "bs": bs, "packed": packed,
               "batches": len(loader), "tail_rows": n_tail,
               "device_ms": None}
        runs = [metrics, metrics2]
        if torch.device(device).type == "cuda":
            from hands_tpu_torch.utils.profiling import device_busy_ms

            with hook("epoch 3"):
                box = {}
                out["device_ms"], _ = device_busy_ms(
                    lambda: box.update(m=trainer.validate(None, loader)),
                    warmup=False)
            runs.append(box["m"])

        t3 = time.time()
        with hook("loader"):
            for _ in loader:
                pass
            _sync(device)
        out["loader_s"] = time.time() - t3

    for k, v in sorted(metrics.items()):
        if not math.isfinite(v):
            raise RuntimeError(f"non-finite metric {k}={v}")
        for other in runs[1:]:
            if abs(v - other[k]) >= AGREE * max(1.0, abs(v)):
                raise RuntimeError(f"epochs disagree on {k}: {v} against "
                                   f"{other[k]}")
    rows = {k: v.float().cpu().numpy() for k, v in tail["metrics"].items()}
    for k, v in rows.items():
        if v.shape[0] != bs or not np.isnan(v[n_tail:]).all():
            raise RuntimeError(f"{k}: the {bs - n_tail} padded rows of the "
                               f"last batch are not all NaN")
    if not np.isfinite(rows["pix_err/h"][:n_tail]).all():
        raise RuntimeError("pix_err/h: a real row of the last batch is NaN")
    print("metrics:", json.dumps(dict(sorted(metrics.items()))))
    print(f"epoch 1 (with the builds): {t_ep1:.2f} s")
    print(f"epoch 2: {t_ep2:.2f} s = {n / t_ep2:,.1f} samples/s end to end "
          f"with the host's fetch")
    if out["device_ms"] is not None:
        print(f"device time of an epoch (a third, under the profiler): "
              f"{out['device_ms']:.1f} ms, {out['device_ms'] / 1e3 / t_ep2:.1%}"
              f" of epoch 2's wall time")
    print(f"loader alone: {out['loader_s']:.2f} s = "
          f"{n / out['loader_s']:,.1f} samples/s (fetch, stack, pin, copy, "
          f"preprocessing; model, metrics and gather ~"
          f"{t_ep2 - out['loader_s']:.2f} s)")
    print(f"padded tail: {bs - n_tail} rows of the last batch NaN in every "
          f"metric")
    out["metrics"], out["epochs"], out["tail"] = metrics, runs, rows
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=5000)
    p.add_argument("--bs", type=int, default=128,
                   help="test batch size (the reference's test_bs is 128)")
    p.add_argument("--model", default="hands_light")
    p.add_argument("--packed", action="store_true",
                   help="pack the records once and sweep from the memmap")
    p.add_argument("--backbone", default=None,
                   help="override cfg.backbone (e.g. resnet18)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; --device cpu "
                           "runs the twins")
    overrides = {"backbone": args.backbone} if args.backbone else {}
    out = sweep(args.n, args.bs, args.model, args.packed, args.device,
                **overrides)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("metrics", "epochs", "tail")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
