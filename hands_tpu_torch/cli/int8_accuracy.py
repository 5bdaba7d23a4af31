"""Output drift of W8A8 int8 serving against bf16 (the port's version of
``scripts/vith_int8_accuracy.py``).

Full-depth ViT-H HaMeR runs twice on one preprocessed batch of 32
synthetic records (the crops of ``SyntheticRecordDataset``'s first 8,
repeated), with the same random weights (seed 0): the bf16 fused block
(K3) against the dynamic int8 block (K5), or K5 with the tanh GELU
(``--fast_gelu``). For every float output it prints the max and mean of the
absolute difference and max / std of the bf16 output. It sets no limit on
the drift.

    python -m hands_tpu_torch.cli.int8_accuracy [--fast_gelu]
    python -m hands_tpu_torch.cli.int8_accuracy --device cpu --vit tiny \\
        --batch 2

On the CPU the blocks' plain twins run.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

SEED = 0  # the weights of both models


def outputs(model, inputs, meta) -> Dict[str, np.ndarray]:
    """{output name: f32 numpy array} of one forward."""
    with torch.inference_mode():
        out = model(inputs, meta)
    return {k: v.float().cpu().numpy() for k, v in out.items()
            if torch.is_tensor(v) and v.is_floating_point() and v.numel()}


def drift(fast_gelu: bool = False, batch: int = 32, device="cuda",
          vit: str = "h") -> Dict[str, dict]:
    """{output: {max, mean, std, max_over_std}} of |int8 - bf16|, printed
    one line an output."""
    from hands_tpu_torch.cli.demo import serving_config
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.registry import fetch_model

    cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
    cfg8 = serving_config("hamer_light", "bfloat16", quant_int8=True,
                          fast_gelu=fast_gelu)
    ds = SyntheticRecordDataset(cfg, "train", length=8)
    recs = [ds[i % len(ds)] for i in range(batch)]
    inputs, _, meta = DevicePreprocessor(cfg, is_train=False, device=device)(
        stack_records(recs))
    model = fetch_model(cfg, device=device, seed=SEED, vit_variant=vit)
    ref = outputs(model, inputs, meta)
    model8 = fetch_model(cfg8, device=device, seed=SEED, vit_variant=vit)
    model8.load_state_dict(model.state_dict(), strict=True)  # same weights
    del model
    got = outputs(model8, inputs, meta)
    tag = "int8 + fast_gelu" if fast_gelu else "int8"
    print(f"bf16 (K3) against {tag} (K5), ViT-{vit}, {batch} images: "
          f"{len(ref)} float outputs")
    rows = {}
    for k in sorted(set(ref) & set(got)):
        d = np.abs(got[k] - ref[k])
        std = max(float(np.abs(ref[k]).std()), 1e-6)
        rows[k] = {"max": float(d.max()), "mean": float(d.mean()),
                   "std": std, "max_over_std": float(d.max()) / std}
        print(f"{k:32s} max {d.max():.3e}  mean {d.mean():.3e}  "
              f"(|ref| std {std:.3e}, max/std {float(d.max()) / std:.3f})")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fast_gelu", action="store_true",
                   help="measure int8 with the tanh GELU (the serving combo)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--vit", default="h", help="ViT variant (h, or tiny)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    drift(args.fast_gelu, args.batch, args.device, args.vit)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
