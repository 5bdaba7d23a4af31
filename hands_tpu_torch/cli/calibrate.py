"""Calibrate static int8 activation scales for the ViT serving path (port of
``hands_tpu/cli/calibrate.py``).

Runs N batches through the plain bf16 forward with the calibration taps on
(``models/backbones/vit.py``), converts the per-channel activation maxima to
symmetric int8 scales, and writes them to an ``.npz`` (keys qkv/proj/mlp1/
mlp2, each (depth, channels); the JAX package reads and writes the same
file). Serving then loads the npz and injects the scales into the
``act_scale_*`` parameters (``ops/calibration.py:inject_scales``) of a model
built with ``Config.quant_int8_static``:

    python -m hands_tpu_torch.cli.calibrate --method hamer_light \\
        [--batches 8] [--batch_size 32] [--margin 1.0] [--device cuda] \\
        -o scales.npz

Weights are random (seed 0), a plumbing smoke run, unless ``--ckpt``
names a HaMeR checkpoint of ``cli.train`` (``<dir>/last`` or
``<dir>/epoch_%04d``; it must hold every entry of the model at its shape,
``train.checkpoint.load_serving_checkpoint``). From Python, pass trained
weights' ``state_dict`` to :func:`calibrate_scales`.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

_POINTS = ("qkv", "proj", "mlp1", "mlp2")


def save_scales_npz(path: str, scales: dict) -> None:
    np.savez(path, **{k: np.asarray(torch.as_tensor(scales[k]).cpu(),
                                    np.float32) for k in _POINTS})


def load_scales_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32))
                for k in _POINTS}


def serving_config(method: str, **overrides):
    """The bf16 serving config calibration runs under."""
    from hands_tpu_torch.config import default_config

    if method not in ("hamer_vith", "hamer_light"):
        raise NotImplementedError(
            f"method '{method}' is not ported: the calibration taps sit on "
            f"HaMeR's ViT blocks; a ViT in WildHands is ROADMAP queue 1 item "
            f"6, the other model families item 7")
    return default_config("hamer_light", compute_dtype="bfloat16",
                          use_render_seg_loss=False, use_grasp_loss=False,
                          **overrides)


def build_model(method: str, vit_variant: str, device="cuda", **overrides):
    """(cfg, model) for a method, without initialised weights (load a
    ``state_dict``); hamer defaults to the full ViT-H."""
    from hands_tpu_torch.models.hamer_light import HamerLightModel

    cfg = serving_config(method, **overrides)
    model = HamerLightModel(cfg, vit_variant=vit_variant, device=device)
    return cfg, model.eval()


def synthetic_batches(cfg, batch_size: int, n_batches: int, device="cuda"
                      ) -> Iterator[Tuple[dict, dict]]:
    """(inputs, meta) eval batches from the synthetic record pipeline."""
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)

    ds = SyntheticRecordDataset(cfg, "train", length=min(batch_size * 2, 16))
    pre = DevicePreprocessor(cfg, is_train=False, device=device)
    for b in range(n_batches):
        recs = [ds[(b * batch_size + i) % len(ds)]
                for i in range(batch_size)]
        inputs, _, meta = pre(stack_records(recs))
        yield inputs, meta


@torch.inference_mode()
def calibrate_scales(method: str, state_dict: dict, batches: Iterable,
                     vit_variant: str = "h", margin: float = 1.0,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Run the calibration forward over ``batches`` of (inputs, meta) with
    the weights of ``state_dict`` and return the scale dict. The state dict
    may come from a plain model or from one built with ``quant_int8_static``
    (its ``act_scale_*`` entries are not needed to collect statistics)."""
    from hands_tpu_torch.ops import calibration as calib

    _, model_cal = build_model(method, vit_variant, device=device,
                               quant_calibrate=True)
    own = model_cal.state_dict()
    model_cal.load_state_dict({k: v for k, v in state_dict.items()
                               if k in own})
    return calib.calibrate(lambda batch: model_cal.net(batch[0]),
                           model_cal.net.backbone, batches, margin=margin)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--method", default="hamer_vith",
                   choices=["hamer_vith", "hamer_light"])
    p.add_argument("--vit_variant", default="h")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--margin", type=float, default=1.0,
                   help=">1 leaves clip headroom for unseen data")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--ckpt", default="",
                   help="HaMeR checkpoint of cli.train: <dir>/last or "
                        "<dir>/epoch_%%04d (default: random weights)")
    p.add_argument("-o", "--out", default="scales.npz")
    args = p.parse_args(argv)

    from hands_tpu_torch.models.registry import fetch_model

    cfg = serving_config(args.method)
    model = fetch_model(cfg, device=args.device, seed=0,
                        vit_variant=args.vit_variant)
    if args.ckpt:
        from hands_tpu_torch.train.checkpoint import load_serving_checkpoint

        load_serving_checkpoint(model, args.ckpt)
        print(f"calibrating checkpoint {args.ckpt}")
    batches = synthetic_batches(cfg, args.batch_size, args.batches,
                                device=args.device)
    scales = calibrate_scales(args.method, model.state_dict(), batches,
                              vit_variant=args.vit_variant,
                              margin=args.margin, device=args.device)
    save_scales_npz(args.out, scales)
    for k in _POINTS:
        s = scales[k].cpu().numpy()
        print(f"{k}: shape {s.shape} scale range "
              f"[{s.min():.3e}, {s.max():.3e}]")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
