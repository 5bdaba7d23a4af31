"""Model factory keyed by method name (port of
``hands_tpu/models/registry.py``): WildHands, ArcticSF, HaMeR and
HandOccNet."""

from __future__ import annotations

import math

import torch
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.xdict import XDict

def _special_inits(model: nn.Module) -> dict:
    """{parameter name: rule} for the parameters that Flax does not draw
    lecun-normal: BatchNorm scales (one; zero for the last of a residual
    block), the HMR decoders (xavier-uniform, gain 0.01) and the fused
    attention in-projections (xavier-uniform)."""
    from hands_tpu_torch.models.backbones.resnet import (BasicBlock,
                                                         BatchNorm, Bottleneck)
    from hands_tpu_torch.models.heads.hmr import (HMRLayer, TfHMRLayer,
                                                  TorchMHA)

    rules = {}
    named = list(model.named_modules())
    for name, mod in named:
        if isinstance(mod, BatchNorm):
            rules[f"{name}.weight"] = "one"
        elif isinstance(mod, (HMRLayer, TfHMRLayer)):
            for key in mod.dec:
                rules[f"{name}.dec.{key}.weight"] = "xavier_0.01"
        elif isinstance(mod, TorchMHA):
            rules[f"{name}.in_proj_weight"] = "xavier"
    for name, mod in named:
        if isinstance(mod, BasicBlock):
            rules[f"{name}.bn2.weight"] = "zero"
        elif isinstance(mod, Bottleneck):
            rules[f"{name}.bn3.weight"] = "zero"
    return rules


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn as Flax's initialisers draw them:
    lecun-normal dense and conv kernels, zero biases, unit LayerNorm and
    BatchNorm scales (zero for the last BatchNorm of a residual block),
    xavier-uniform attention in-projections and (gain 0.01) HMR decoders,
    N(0, 0.02) ViT position embeddings, N(0, 1) decoder query embedding and
    HandOccNet q/k position maps, unit static activation scales and
    HandOccNet heatmap temperatures (``betas``). Buffers (BatchNorm running statistics)
    keep their constructor values, mean 0 and variance 1."""
    special = _special_inits(model)

    def draw(p, uniform=False):
        fn = torch.rand if uniform else torch.randn
        return fn(p.shape, generator=generator, device=generator.device)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        rule = special.get(name)
        if rule == "zero" or leaf in ("bias", "patch_bias", "in_proj_bias"):
            p.zero_()
        elif (rule == "one" or leaf in ("scale", "betas")
              or leaf.startswith("act_scale_")):
            p.fill_(1.0)  # act_scale_*: until calibration fills them
        elif rule is not None:  # xavier-uniform on an (out, in) matrix
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            gain = 0.01 if rule == "xavier_0.01" else 1.0
            p.copy_((draw(p, uniform=True) * 2.0 - 1.0) * (bound * gain))
        else:
            if leaf == "pos_embed":
                std = 0.02
            elif leaf in ("pos_embedding", "q_embedding", "k_embedding"):
                std = 1.0
            else:  # (out, in[, kh, kw]) kernels
                std = 1.0 / math.sqrt(p[0].numel())
            p.copy_(draw(p) * std)
    return model


def fetch_model(cfg: Config, device="cuda", seed: int = 0,
                vit_variant: str = "h", param_dtype=None) -> nn.Module:
    """Build the model for ``cfg.method`` on ``device`` (the card unless the
    caller names the CPU; without a card that raises) with random weights
    from ``seed`` (load trained weights with ``load_state_dict``, e.g. from
    ``hands_tpu_torch.utils.from_jax``), in eval mode. To train a bf16
    HaMeR, pass ``param_dtype=torch.float32``: f32 master parameters, cast
    to bf16 per call (WildHands always stores f32)."""
    method = cfg.method
    if method in ("hamer_light", "hamer"):
        from hands_tpu_torch.models.hamer_light import HamerLightModel

        model = HamerLightModel(cfg, vit_variant=vit_variant, device=device,
                                param_dtype=param_dtype)
    elif method in ("hands_light", "hands"):
        from hands_tpu_torch.models.hands_light import HandsLightModel

        model = HandsLightModel(cfg, device=device)
    elif method in ("arctic_sf_light", "arctic_sf"):
        from hands_tpu_torch.models.arctic_light import ArcticSFLightModel

        model = ArcticSFLightModel(cfg, device=device)
    elif method in ("handoccnet_light", "handoccnet"):
        from hands_tpu_torch.models.handoccnet_light import \
            HandOccNetLightModel

        model = HandOccNetLightModel(cfg, device=device)
    else:
        raise KeyError(f"unknown method '{method}'")
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_weights_(model, gen).eval()


@torch.inference_mode()
def inference_pose(model, inputs, meta_info) -> XDict:
    """Single-batch inference: run the model and return the merged
    ``{inputs.*, pred.*, meta_info.*}`` XDict."""
    pred = model(inputs, meta_info)
    out = XDict()
    out.merge(XDict(inputs).prefix("inputs."))
    out.merge(XDict(pred).prefix("pred."))
    out.merge(XDict(meta_info).prefix("meta_info."))
    return out
