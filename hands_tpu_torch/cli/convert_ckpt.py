"""Convert a released torch checkpoint into the port's key layout (port of
``hands_tpu/cli/convert_ckpt.py``).

The reference warm-starts its backbones from released torch weights
(ViTPose-B/H and whole HaMeR checkpoints; torchvision ResNets with
``pretrained=True``). This CLI renames their keys once, offline, into one
``torch.save`` file of the port's keys:

    python -m hands_tpu_torch.cli.convert_ckpt \\
        --src resnet50.pth --arch resnet50 --out ./ckpts/resnet50.pt
    python -m hands_tpu_torch.cli.convert_ckpt \\
        --src vitpose_huge.pth --arch vit_h --out ./ckpts/vit_h.pt \\
        --target_grid 16 12

Arches:
- ``resnet18`` / ``resnet50``: a ``ResNet``'s keys, without a scope;
- ``vit_b16`` / ``vit_h``: a ``ViTBackbone``'s (class token folded, the
  position grid resized bicubically to ``--target_grid``);
- ``hamer``: a released HaMeR ``.ckpt``'s ``backbone.*`` as ``vit_h``;
- ``wildhands`` / ``handoccnet``: a whole network, keyed ``net.*`` as the
  port's model holds it.

A backbone file warm-starts training through ``--load_backbone`` (every
top-level scope of the model that holds its keys at their shapes receives
them: one ResNet file fills both of WildHands' backbones,
``train/checkpoint.py:graft_backbone_variables``); a whole network loads
through ``--load_ckpt``.
"""

from __future__ import annotations

import argparse

import torch

from hands_tpu_torch.utils import torch_import as ti

# position grids of the released ViTPose weights (256x192 input, patch 16)
_SRC_GRIDS = {"vit_b16": (16, 12), "vit_h": (16, 12)}
_DEPTHS = {"vit_b16": 12, "vit_h": 32}
ARCHES = ("resnet18", "resnet50", "vit_b16", "vit_h", "hamer", "wildhands",
          "handoccnet")


def _unwrap(sd: dict) -> dict:
    """Released Lightning checkpoints wrap the network as ``model.``."""
    if any(k.startswith("model.") for k in sd):
        return {k[len("model."):]: v for k, v in sd.items()
                if k.startswith("model.")}
    return sd


def convert(src: str, arch: str, target_grid=None) -> dict:
    """The converted ``state_dict`` of the checkpoint file ``src``."""
    if arch == "hamer":
        return ti.import_hamer_checkpoint(src)
    sd = ti.load_torch_state_dict(src)
    if arch in ("resnet18", "resnet50"):
        stages = (2, 2, 2, 2) if arch == "resnet18" else (3, 4, 6, 3)
        return ti.import_resnet(sd, stage_sizes=stages)
    if arch in ("vit_b16", "vit_h"):
        return ti.import_vit(sd, depth=_DEPTHS[arch], target_grid=target_grid,
                             src_grid=_SRC_GRIDS[arch])
    if arch == "handoccnet":
        net = ti.import_handoccnet(_unwrap(sd))
    elif arch == "wildhands":
        sd = _unwrap(sd)
        # bottleneck blocks (resnet50) have a conv3
        bb = ("resnet50" if "hand_backbone.layer1.0.conv3.weight" in sd
              else "resnet18")
        net = ti.import_hands_trunk(sd, backbone=bb)
    else:
        raise ValueError(f"unknown arch '{arch}'")
    return {f"net.{k}": v for k, v in net.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", required=True, help="torch .pth/.ckpt file")
    p.add_argument("--arch", required=True, choices=ARCHES)
    p.add_argument("--out", required=True, help="output file (torch.save)")
    p.add_argument("--target_grid", type=int, nargs=2, default=None,
                   help="(h, w) position-embedding token grid of the target "
                        "model; resized bicubically from the checkpoint's "
                        "grid when it differs")
    args = p.parse_args(argv)
    sd = convert(args.src, args.arch,
                 target_grid=tuple(args.target_grid)
                 if args.target_grid else None)
    torch.save(sd, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.out} ({args.arch}, {n / 1e6:.1f}M values)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
