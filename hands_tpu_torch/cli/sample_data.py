"""Data-format smoke test (port of ``hands_tpu/cli/sample_data.py``): load
the ``sample`` dataset (the synthetic one when its files are absent), run
MANO FK of the ground-truth parameters (K1, ``lbs_apply``, on the card),
reproject it, and draw the annotated and the reprojected 2D joints over the
crops into ``logs/sample_data/sample_<i>.png`` so that a human can check the
loader's geometry. Prints each crop's mean FK-against-GT reprojection error
in pixels.

    python -m hands_tpu_torch.cli.sample_data [--device cpu] [JAX flags]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

OUT_DIR = "logs/sample_data"


def main(argv=None):
    """Returns the mean reprojection error of each crop, in pixels."""
    from PIL import Image, ImageDraw

    from hands_tpu_torch.cli._args import parse
    from hands_tpu_torch.core.precision import f32_exact
    from hands_tpu_torch.data.datasets import fetch_dataset
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.ops import mano as manolib
    from hands_tpu_torch.utils.vis import (RIGHT_RGB, draw_crosses,
                                           draw_dots, titled, to_uint8)

    cfg, device = parse(argv)
    # GT intrinsics: with the fixed weak-perspective K the 3D targets live
    # in the real camera and j2d in patch space, so the FK reprojection
    # lines up only under the patch-adjusted GT K
    cfg = cfg.replace(use_gt_k=True)
    try:
        ds = fetch_dataset(cfg, "sample", "train")
    except FileNotFoundError:
        print("sample dataset files not found; falling back to synthetic")
        ds = fetch_dataset(cfg, "synthetic", "train")
    os.makedirs(OUT_DIR, exist_ok=True)

    records = [ds[i] for i in range(min(4, len(ds)))]
    pre = DevicePreprocessor(cfg, is_train=False, device=device)
    inputs, targets, meta = pre(stack_records(records))

    # FK of the GT MANO parameters, reprojected: both overlays land on the
    # hand if the dataset's geometry is consistent
    with torch.no_grad(), f32_exact():
        out = manolib.mano_forward(
            manolib.load_mano(True, device=device), targets["mano.beta.r"],
            targets["mano.pose.r"][:, 3:], targets["mano.pose.r"][:, :3])
        T0 = (targets["mano.j3d.full.r"] - out.joints).mean(dim=1)
        proj = torch.einsum("bij,bnj->bni", meta["intrinsics"],
                            out.joints + T0[:, None, :])
        j2d_fk = (proj[..., :2] / torch.clamp(proj[..., 2:], min=1e-9)
                  ).cpu().numpy()
    j2d_gt = (targets["mano.j2d.norm.r"][..., :2].cpu().numpy() + 1) \
        * 0.5 * cfg.img_res

    mean = np.asarray(cfg.img_norm_mean)
    std = np.asarray(cfg.img_norm_std)
    errs = []
    for i, rec in enumerate(records):
        img = inputs["img"][i].float().cpu().numpy() * std + mean
        panel = Image.fromarray(to_uint8(img))
        draw = ImageDraw.Draw(panel)
        draw_dots(draw, j2d_gt[i], (0, 255, 0))  # GT j2d
        draw_crosses(draw, j2d_fk[i], RIGHT_RGB)  # MANO FK reprojected
        draw.text((2, 2), "GT j2d", fill=(0, 255, 0))
        draw.text((2, 13), "MANO FK reproj", fill=RIGHT_RGB)
        path = os.path.join(OUT_DIR, f"sample_{i}.png")
        titled(panel, str(rec.imgname)).save(path)
        err = float(np.linalg.norm(j2d_fk[i] - j2d_gt[i], axis=-1).mean())
        errs.append(err)
        print(f"sample {i}: mean FK-vs-GT reprojection err {err:.2f}px "
              f"-> {path}")
    return errs


if __name__ == "__main__":
    main(sys.argv[1:])
