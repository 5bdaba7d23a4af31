"""Batch hand-pose serving with the PyTorch port (port of the batch-serving
path of ``hands_tpu/cli/demo.py:run_demo``).

    python -m hands_tpu_torch.cli.demo --dir photos/ --batch_size 8
    python -m hands_tpu_torch.cli.demo --dir photos/ --batch_size 8 \\
        --method hamer_light --dtype bfloat16 --fused_block
    python -m hands_tpu_torch.cli.demo --dir photos/ --method hamer_light \\
        --dtype bfloat16 --int8 --fast_gelu

The default method is WildHands (``hands_light``), as in the JAX demo. It
runs on the card (``--device cuda``) unless ``--device cpu`` is given.
``--int8`` serves W8A8: HaMeR through the dynamic int8 block kernels (it
implies ``--fused_block``), WildHands through the int8 serving convolution
of its ResNets. The static-calibrated variant is served from Python:
``serving_config(..., quant_int8_static=True)``, ``fetch_model``, then
``ops.calibration.inject_scales`` with the scales of
``python -m hands_tpu_torch.cli.calibrate``, then :func:`serve`.

Flow: decoded images -> ``Record`` -> ``stack_records`` -> on-device
``DevicePreprocessor`` -> ``fetch_model`` -> ``inference_pose``; writes
``<stem>_pred.npz`` per image (MANO pose/betas, 3D joints and vertices,
camera) and, unless ``--no_vis``, the overlay figures of
``utils/vis.visualize_all`` as ``<stem>_<figure>.png`` (the keypoint grids
and the [input | render] strip). :func:`serve` is the same flow on
in-memory records, without files.
Weights are random from ``--seed``, or ``--ckpt <dir>/last`` (or
``<dir>/epoch_%04d``) serves a checkpoint that ``cli.train`` wrote; it must
hold every entry of the served model at its shape
(``train.checkpoint.load_serving_checkpoint``):

    python -m hands_tpu_torch.cli.demo --dir photos/ \\
        --ckpt logs/<key>/checkpoints/last
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import List

import numpy as np

from hands_tpu_torch.config import Config, default_config
from hands_tpu_torch.data.records import Record, default_flags


def serving_config(method: str = "hamer_light", dtype: str = "float32",
                   fused_block: bool = False, quant_int8: bool = False,
                   quant_int8_static: bool = False,
                   fast_gelu: bool = False) -> Config:
    """The demo's config: render and grasp heads off (the methods' defaults
    turn both on). ``quant_int8_static`` implies ``quant_int8``,
    which implies ``fused_block`` (``default_config``)."""
    return default_config(method, use_render_seg_loss=False,
                          use_grasp_loss=False, compute_dtype=dtype,
                          fused_block=fused_block, quant_int8=quant_int8,
                          quant_int8_static=quant_int8_static,
                          fast_gelu=fast_gelu)


def make_record(path: str, img: np.ndarray, r_box=None, l_box=None,
                focal=None) -> Record:
    """One request: the whole image, optional hand boxes (x0,y0,x1,y1 image
    pixels; the full image when absent) and an optional focal length."""
    H, W = img.shape[:2]
    f = 1000.0 if focal is None else float(focal)
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return Record(
        imgname=path, image=img, K=K, r_bbox=r_box, l_bbox=l_box,
        bbox_mode=1.0,  # crop from the provided boxes
        use_gt_k=0.0 if focal is None else 1.0,  # weak-persp K by default
        right_valid=1.0, left_valid=1.0, loss_flags=default_flags(),
        dataset="demo")


def pad_to_common_size(records: List[Record]) -> None:
    """Zero-pad every image bottom/right to the largest H and W (principal
    point and boxes are unchanged), so one batch has one raw shape."""
    max_h = max(r.image.shape[0] for r in records)
    max_w = max(r.image.shape[1] for r in records)
    for r in records:
        h, w = r.image.shape[:2]
        if (h, w) != (max_h, max_w):
            canvas = np.zeros((max_h, max_w, 3), r.image.dtype)
            canvas[:h, :w] = r.image
            r.image = canvas


def serve_with_targets(records: List[Record], cfg: Config, model, device):
    """One batch of same-shape records -> (the ``{inputs.*, pred.*,
    meta_info.*}`` XDict of ``inference_pose``, the preprocessor's targets),
    tensors on ``device``."""
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.registry import inference_pose

    pre = DevicePreprocessor(cfg, is_train=False, device=device)
    inputs, targets, meta = pre(stack_records(records))
    return inference_pose(model, inputs, meta), targets


def serve(records: List[Record], cfg: Config, model, device):
    """One batch of same-shape records -> the ``{inputs.*, pred.*,
    meta_info.*}`` XDict of ``inference_pose``, tensors on ``device``."""
    return serve_with_targets(records, cfg, model, device)[0]


def save_png(img, path: str) -> None:
    """An HWC image (uint8, or float in [0, 1] or [0, 255]) -> a PNG."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.001 else 1.0),
                      0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def save_overlays(out, targets, cfg: Config, chunk: List[Record], n_real: int,
                  out_dir: str) -> List[str]:
    """The figures of the first ``n_real`` requests of a served chunk as
    ``<out_dir>/<stem>_<figure>.png``; returns the paths. Drawing failures
    are reported, not raised: the overlays must not stop the serving."""
    from hands_tpu_torch.core.xdict import XDict
    from hands_tpu_torch.utils.vis import visualize_all

    vis_dict = XDict(out)
    vis_dict.merge(XDict(targets).prefix("targets."))
    paths = []
    try:
        for name, im in visualize_all(vis_dict, cfg, max_examples=n_real):
            idx = int(name.split("__")[0] or 0)
            stem = os.path.splitext(os.path.basename(chunk[idx].imgname))[0]
            paths.append(os.path.join(
                out_dir, f"{stem}_{name.replace('/', '_')}.png"))
            save_png(im, paths[-1])
    except Exception as e:  # vis must not kill the demo
        print(f"visualization failed (non-fatal): {e}")
    return paths


def run_demo(argv=None, overrides=None) -> int:
    """The demo on ``argv``; ``overrides`` are ``Config`` fields set from
    Python (a checkpoint of a narrower model, e.g. in tests)."""
    import glob

    from hands_tpu_torch.data.datasets import _read_image
    from hands_tpu_torch.models.registry import fetch_model

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img", nargs="+", default=[], help="image path(s)")
    p.add_argument("--dir", default="", help="directory of jpg/png images")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--method", default="hands_light",
                   choices=["hands_light", "hamer_light", "arctic_sf_light",
                            "handoccnet_light"])
    p.add_argument("--fused_block", action="store_true",
                   help="hamer_light: fused ViT-block CUDA kernels (bf16 only)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 serving through the int8 block kernels "
                        "(lossy; implies --fused_block, bf16 only)")
    p.add_argument("--fast_gelu", action="store_true",
                   help="tanh-approximate GELU (lossy serving knob)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default="",
                   help="checkpoint of cli.train to serve: <dir>/last or "
                        "<dir>/epoch_%%04d (default: random weights)")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--r_bbox", default=None, help="x0,y0,x1,y1")
    p.add_argument("--l_bbox", default=None, help="x0,y0,x1,y1")
    p.add_argument("--focal", type=float, default=None)
    p.add_argument("--no_vis", action="store_true",
                   help="skip the overlay PNGs (predictions npz only)")
    args = p.parse_args(argv)

    def box(s):
        if s is None:
            return None
        vals = [float(v) for v in s.split(",")]
        if len(vals) != 4:
            raise ValueError(f"bbox must be x0,y0,x1,y1 — got '{s}'")
        return np.asarray(vals, np.float32)

    cfg = serving_config(args.method, args.dtype, args.fused_block,
                         quant_int8=args.int8, fast_gelu=args.fast_gelu)
    if overrides:
        cfg = cfg.replace(**overrides)
    paths = list(args.img)
    if args.dir:
        for ext in ("jpg", "jpeg", "png", "JPG", "JPEG", "PNG"):
            paths += sorted(glob.glob(os.path.join(args.dir, f"*.{ext}")))
    records = []
    for path in paths:
        img, ok = _read_image(path)
        if not ok:
            print(f"WARNING: could not decode {path}; skipping")
            continue
        records.append(make_record(path, img, box(args.r_bbox),
                                   box(args.l_bbox), args.focal))
    if not records:
        print("no decodable input images (--img or --dir)")
        return 1
    pad_to_common_size(records)

    os.makedirs(args.out, exist_ok=True)
    model = fetch_model(cfg, device=args.device, seed=args.seed)
    if args.ckpt:
        from hands_tpu_torch.train.checkpoint import load_serving_checkpoint

        load_serving_checkpoint(model, args.ckpt)
        print(f"serving checkpoint {args.ckpt}")
    bs = max(1, min(args.batch_size, len(records)))
    for s in range(0, len(records), bs):
        chunk = list(records[s:s + bs])
        n_real = len(chunk)
        while len(chunk) < bs:  # pad the tail chunk to the fixed batch
            pad = copy.copy(chunk[-1])
            pad.right_valid = 0.0
            pad.left_valid = 0.0
            chunk.append(pad)
        out, targets = serve_with_targets(chunk, cfg, model, args.device)
        out_np = out.to_np()
        keep = [k for k in out_np if k.startswith("pred.mano.")
                or k == "pred.feat_vec"]
        for i in range(n_real):
            stem = os.path.splitext(os.path.basename(chunk[i].imgname))[0]
            np.savez(os.path.join(args.out, f"{stem}_pred.npz"),
                     **{k: out_np[k][i] for k in keep})
        if not args.no_vis:
            save_overlays(out, targets, cfg, chunk, n_real, args.out)
    print(f"wrote predictions for {len(records)} image(s) -> {args.out}")
    return 0


def main(argv=None, overrides=None):
    return run_demo(argv, overrides)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
