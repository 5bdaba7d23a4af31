"""Read released torch checkpoints into the port (port of
``hands_tpu/utils/torch_import.py``).

Each importer takes a reference ``state_dict`` (torch tensors, the key
layout of the upstream module) and returns a ``state_dict`` of the port's
module that it fills, keyed relative to that module:

- torchvision ResNet-18/50 -> :func:`import_resnet` (``models/backbones/
  resnet.ResNet``);
- ViTPose / HaMeR ViT -> :func:`import_vit` (``ViTBackbone``), with the
  class token's position folded into the grid and the grid resized to the
  target's; a released HaMeR ``.ckpt`` -> :func:`import_hamer_checkpoint`;
- HaMeR's decoder head -> :func:`import_hamer_head`;
- a WildHands checkpoint -> :func:`import_hands_trunk` (``HandsLightNet``);
- HandOccNet -> :func:`import_handoccnet_fpn`,
  :func:`import_handoccnet_transformer`, :func:`import_handoccnet_regressor`
  and the whole network, :func:`import_handoccnet` (``HandOccNetNet``).

The port keeps torch's layouts (OIHW convolutions, (out, in) dense
weights), so most of this is renaming. Two pieces compute: the position
embedding's class-token fold ``pos[:, 1:] + pos[:, :1]`` and its grid
resize, ``jax.image.resize``'s bicubic (Keys' cubic, a = -0.5, antialiased
where it shrinks; ``ops/resize.py``). And where the reference flattens a
(C, H, W) map into a linear layer, the port flattens (H, W, C), so that
layer's columns are permuted (:func:`_hwc_columns`).
"""

from __future__ import annotations

from typing import Dict

import torch

from hands_tpu_torch.ops.resize import resize

StateDict = Dict[str, torch.Tensor]


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def _sub(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _prefixed(sd: StateDict, prefix: str) -> StateDict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def _copy(out: StateDict, sd: Dict, pairs) -> None:
    """out[dst] = sd[src] for each (dst, src)."""
    for dst, src in pairs:
        out[dst] = _t(sd[src])


def _linear(dst: str, src: str):
    return [(f"{dst}.weight", f"{src}.weight"), (f"{dst}.bias", f"{src}.bias")]


def _bn(dst: str, src: str):
    return [(f"{dst}.{k}", f"{src}.{k}")
            for k in ("weight", "bias", "running_mean", "running_var")]


def _conv(sd: Dict, dst: str, src: str):
    """A convolution with its bias where the reference has one."""
    pairs = [(f"{dst}.weight", f"{src}.weight")]
    if f"{src}.bias" in sd:
        pairs.append((f"{dst}.bias", f"{src}.bias"))
    return pairs


def _hwc_columns(w: torch.Tensor, c: int, h: int, w_: int) -> torch.Tensor:
    """A linear weight (out, C*H*W) that read a (C, H, W)-major flatten ->
    the same weight reading the port's (H, W, C)-major flatten."""
    return (w.reshape(-1, c, h, w_).permute(0, 2, 3, 1)
            .reshape(w.shape[0], c * h * w_).contiguous())


def import_resnet(state_dict: Dict, stage_sizes=(3, 4, 6, 3)) -> StateDict:
    """torchvision ResNet ``state_dict`` -> the port ``ResNet``'s
    (bottleneck blocks for (3, 4, 6, 3), basic blocks for (2, 2, 2, 2))."""
    sd = state_dict
    out: StateDict = {}
    _copy(out, sd, [("conv_stem.weight", "conv1.weight")]
          + _bn("bn_stem", "bn1"))
    bottleneck = (tuple(stage_sizes) == (3, 4, 6, 3)
                  or "layer1.0.conv3.weight" in sd)
    n_convs = 3 if bottleneck else 2
    for i, blocks in enumerate(stage_sizes):
        for j in range(blocks):
            src, dst = f"layer{i + 1}.{j}", f"stages.{i}.{j}"
            pairs = []
            for k in range(1, n_convs + 1):
                pairs += [(f"{dst}.conv{k}.weight", f"{src}.conv{k}.weight")]
                pairs += _bn(f"{dst}.bn{k}", f"{src}.bn{k}")
            if f"{src}.downsample.0.weight" in sd:
                pairs += [(f"{dst}.down_conv.weight",
                           f"{src}.downsample.0.weight")]
                pairs += _bn(f"{dst}.down_bn", f"{src}.downsample.1")
            _copy(out, sd, pairs)
    return out


def resize_pos_grid(pos: torch.Tensor, src_grid, target_grid) -> torch.Tensor:
    """(1, h*w, C) position embeddings on the ``src_grid`` (h, w) -> on
    ``target_grid``: ``jax.image.resize(..., "bicubic")`` of the grid."""
    sh, sw = src_grid
    th, tw = target_grid
    grid = pos.reshape(1, sh, sw, -1)
    return resize(grid, th, tw, "bicubic").reshape(1, th * tw, -1)


def import_vit(state_dict: Dict, depth: int = 32, target_grid=None,
               src_grid=None) -> StateDict:
    """ViTPose/HaMeR ViT ``state_dict`` -> the port ``ViTBackbone``'s: patch
    embedding, position embedding (a leading class token folded into the
    grid, as the reference adds ``pos[:, :1]`` to ``pos[:, 1:]``; the grid
    resized when ``target_grid`` differs from the checkpoint's
    ``src_grid``), the ``depth`` blocks and the last LayerNorm."""
    sd = state_dict
    out: StateDict = {}
    _copy(out, sd, [("patch_embed.weight", "patch_embed.proj.weight"),
                    ("patch_bias", "patch_embed.proj.bias")])
    pos = _t(sd["pos_embed"])
    if pos.shape[1] % 2 == 1:  # a leading class token: fold it in
        pos = pos[:, 1:] + pos[:, :1]
    if (target_grid is not None and src_grid is not None
            and tuple(target_grid) != tuple(src_grid)):
        pos = resize_pos_grid(pos, src_grid, target_grid)
    out["pos_embed"] = pos
    pairs = []
    for i in range(depth):
        src = dst = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            pairs += [(f"{dst}.{norm}.scale", f"{src}.{norm}.weight"),
                      (f"{dst}.{norm}.bias", f"{src}.{norm}.bias")]
        pairs += (_linear(f"{dst}.attn.qkv", f"{src}.attn.qkv")
                  + _linear(f"{dst}.attn.proj", f"{src}.attn.proj")
                  + _linear(f"{dst}.mlp.fc1", f"{src}.mlp.fc1")
                  + _linear(f"{dst}.mlp.fc2", f"{src}.mlp.fc2"))
    pairs += [("last_norm.scale", "last_norm.weight"),
              ("last_norm.bias", "last_norm.bias")]
    _copy(out, sd, pairs)
    return out


def load_torch_state_dict(path: str) -> Dict:
    """A torch checkpoint file -> its flat ``state_dict`` (on the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return ckpt


def import_hamer_checkpoint(path: str) -> StateDict:
    """A released HaMeR ``.ckpt`` -> its ViT-H backbone (the ``backbone.``
    entries) as a ``ViTBackbone`` state dict."""
    return import_vit(_sub(load_torch_state_dict(path), "backbone."),
                      depth=32)


def import_hamer_head(state_dict: Dict) -> StateDict:
    """HaMeR's ``MANOTransformerDecoderHead`` ``state_dict`` (without the
    ``mano_head.`` prefix) -> the port ``ManoTransformerDecoderHead``'s. The
    self-attention's fused ``to_qkv`` splits into ``to_q`` (its first third
    of rows) and ``to_kv``."""
    sd = state_dict
    out: StateDict = {}
    _copy(out, sd, _linear("token_proj", "transformer.to_token_embedding")
          + [("pos_embedding", "transformer.pos_embedding")]
          + _linear("decpose", "decpose") + _linear("decshape", "decshape")
          + _linear("deccam", "deccam"))
    i = 0
    while f"transformer.transformer.layers.{i}.0.norm.weight" in sd:
        src, dst = f"transformer.transformer.layers.{i}", f"layers.{i}"
        pairs = []
        for k in range(3):
            pairs += [(f"{dst}.norm{k}.scale", f"{src}.{k}.norm.weight"),
                      (f"{dst}.norm{k}.bias", f"{src}.{k}.norm.bias")]
        pairs += (_linear(f"{dst}.self_attn.to_out", f"{src}.0.fn.to_out.0")
                  + [(f"{dst}.cross_attn.to_q.weight",
                      f"{src}.1.fn.to_q.weight"),
                     (f"{dst}.cross_attn.to_kv.weight",
                      f"{src}.1.fn.to_kv.weight")]
                  + _linear(f"{dst}.cross_attn.to_out", f"{src}.1.fn.to_out.0")
                  + _linear(f"{dst}.fc1", f"{src}.2.fn.net.0")
                  + _linear(f"{dst}.fc2", f"{src}.2.fn.net.3"))
        _copy(out, sd, pairs)
        qkv = _t(sd[f"{src}.0.fn.to_qkv.weight"])  # (3 inner, dim)
        inner = qkv.shape[0] // 3
        out[f"{dst}.self_attn.to_q.weight"] = qkv[:inner].clone()
        out[f"{dst}.self_attn.to_kv.weight"] = qkv[inner:].clone()
        i += 1
    return out


def _hand_hmr(sd: Dict) -> StateDict:
    """One WildHands ``HandHMR`` (keys without the ``head_r.`` prefix)."""
    pairs = []
    for i, src in enumerate(("cam_init.0", "cam_init.2", "cam_init.4")):
        pairs += _linear(f"cam_init.{i}", src)
    if "hmr_layer.feat_mlp.0.weight" in sd:  # the tf_decoder head
        layer = "tf_hmr_layer"
        pairs += _linear("cam_init_pre", "cam_init_precursor.0")
        for dst, src in (
                ("vector_mlp_dense", "hmr_layer.vector_mlp.0"),
                ("feat_mlp_dense", "hmr_layer.feat_mlp.0"),
                ("dec_linear1", "hmr_layer.refine_decoder.layers.0.linear1"),
                ("dec_linear2", "hmr_layer.refine_decoder.layers.0.linear2"),
                ("enc_linear1", "hmr_layer.self_attn.layers.0.linear1"),
                ("enc_linear2", "hmr_layer.self_attn.layers.0.linear2")):
            pairs += _linear(f"{layer}.{dst}", src)
        for dst, src in (
                ("dec_self_attn", "hmr_layer.refine_decoder.layers.0.self_attn"),
                ("dec_cross_attn",
                 "hmr_layer.refine_decoder.layers.0.multihead_attn"),
                ("enc_self_attn", "hmr_layer.self_attn.layers.0.self_attn")):
            pairs += [(f"{layer}.{dst}.in_proj_weight", f"{src}.in_proj_weight"),
                      (f"{layer}.{dst}.in_proj_bias", f"{src}.in_proj_bias")]
            pairs += _linear(f"{layer}.{dst}.out_proj", f"{src}.out_proj")
    else:
        layer = "hmr_layer"
        pairs += (_linear(f"{layer}.refine0", "hmr_layer.refine.0")
                  + _linear(f"{layer}.refine1", "hmr_layer.refine.3"))
    for key, src in (("pose_6d", "hmr_layer.decoders.pose_6d"),
                     ("cam_t_wp", "hmr_layer.decoders.cam_t/wp"),
                     ("shape", "hmr_layer.decoders.shape")):
        pairs += _linear(f"{layer}.dec.{key}", src)
    out: StateDict = {}
    _copy(out, sd, pairs)
    return out


def _grasp(sd: Dict) -> StateDict:
    out: StateDict = {}
    _copy(out, sd, [p for i, j in enumerate((0, 2, 4, 6))
                    for p in _linear(f"grasp_classifier.layers.{i}",
                                     f"grasp_classifier.{j}")])
    return out


def import_hands_trunk(state_dict: Dict, backbone: str = "resnet18"
                       ) -> StateDict:
    """A WildHands (``hands_light``) checkpoint (keys without a wrapper
    prefix) -> the port ``HandsLightNet``'s: the ResNet backbones, the
    feature convolutions (their linear layer reading the port's (H, W, C)
    flatten), both HMR heads, and where the checkpoint has them the grasp
    classifier, the depth decoder and the centre and corner heads."""
    sd = state_dict
    stages = (2, 2, 2, 2) if backbone == "resnet18" else (3, 4, 6, 3)
    out: StateDict = {}
    for side in ("r", "l"):
        out.update(_prefixed(_hand_hmr(_sub(sd, f"head_{side}.")),
                             f"head_{side}."))
    if "head_r.hmr_layer.feat_mlp.0.weight" not in sd:
        # a tf_decoder trunk builds feature_conv but never calls it; the
        # port's tf_decoder model has no such module
        _copy(out, sd, [("feature_conv.conv0.weight", "feature_conv.0.weight"),
                        ("feature_conv.conv1.weight", "feature_conv.2.weight"),
                        ("feature_conv.conv2.weight", "feature_conv.4.weight"),
                        ("feature_conv.dense.bias", "feature_conv.7.bias")])
        out["feature_conv.dense.weight"] = _hwc_columns(
            _t(sd["feature_conv.7.weight"]), 256, 3, 3)
    if any(k.startswith("hand_backbone_r.") for k in sd):
        # separate_hands builds a backbone per side
        for side in ("r", "l"):
            out.update(_prefixed(import_resnet(
                _sub(sd, f"hand_backbone_{side}."), stages),
                f"backbone_{side}."))
    else:
        out.update(_prefixed(import_resnet(_sub(sd, "hand_backbone."),
                                           stages), "hand_backbone."))
    if any(k.startswith("backbone.") for k in sd):
        out.update(_prefixed(import_resnet(_sub(sd, "backbone."), stages),
                             "glb_backbone."))
    if any(k.startswith("grasp_classifier.") for k in sd):
        out.update(_grasp(sd))
    if any(k.startswith("depth_mlp.") for k in sd):
        # the conv indices skip the Sequential's ReLU and Upsample entries
        _copy(out, sd, [p for i, j in enumerate((0, 2, 5, 7, 10, 12, 15, 17))
                        for p in _linear(f"depth_head.convs.{i}",
                                         f"depth_mlp.{j}")])
    for head in ("center_head", "corner_head"):
        if any(k.startswith(f"{head}.") for k in sd):
            _copy(out, sd, [p for i, j in enumerate((0, 2, 4))
                            for p in _linear(f"{head}.layers.{i}",
                                             f"{head}.{j}")])
    return out


def _hg_residual(sd: Dict, dst: str, src: str, bns) -> list:
    """A reference ``Bottleneck`` (bn1/2/3) or ``Residual`` (bn/bn1/bn2)
    with conv1/2/3 -> the port ``HGResidual`` (bn0/1/2, conv0/1/2)."""
    pairs = []
    for k, bn in enumerate(bns):
        pairs += _bn(f"{dst}.bn{k}", f"{src}.{bn}")
        pairs += _conv(sd, f"{dst}.conv{k}", f"{src}.conv{k + 1}")
    return pairs


_BOTTLENECK = ("bn1", "bn2", "bn3")
_RESIDUAL = ("bn", "bn1", "bn2")


def import_handoccnet_regressor(state_dict: Dict) -> StateDict:
    """HandOccNet's regressor chain (``hand_regHead.`` stacked hourglass
    and spatial softmax, ``hand_Encoder.``, ``mano_regHead.``) -> the port
    ``Regressor``'s. The encoder's (256, 2, 2) feature is flattened
    (C, H, W)-major in the reference, so the first MLP layer's columns are
    permuted to the port's (H, W, C) flatten."""
    sd = state_dict
    pairs = []
    # hg[i] serves recursion level i + 1; the port names the levels by
    # "_d" nesting depth from the top
    for i, pref in ((3, "hg"), (2, "hg_d"), (1, "hg_d_d"), (0, "hg_d_d_d")):
        for j, suf in ((0, "_up"), (1, "_low1"), (2, "_low3")):
            pairs += _hg_residual(sd, f"hourglass.res.{pref}{suf}",
                                  f"hand_regHead.hg.0.hg.{i}.{j}.0",
                                  _BOTTLENECK)
    pairs += _hg_residual(sd, "hourglass.res.hg_d_d_d_mid",
                          "hand_regHead.hg.0.hg.0.3.0", _BOTTLENECK)
    pairs += _hg_residual(sd, "res", "hand_regHead.res.0.0", _BOTTLENECK)
    pairs += (_conv(sd, "fc", "hand_regHead.fc.0.block.0")
              + _bn("fc_bn", "hand_regHead.fc.0.block.1")
              + _conv(sd, "score", "hand_regHead.score.0")
              + _conv(sd, "heatmap_conv", "hand_Encoder.heatmap_conv")
              + _conv(sd, "encoding_conv", "hand_Encoder.encoding_conv"))
    for k in range(8):
        pairs += _hg_residual(sd, f"reg.{k}", f"hand_Encoder.reg.{k}",
                              _RESIDUAL)
    pairs += [("fc1.bias", "mano_regHead.mano_base_layer.0.bias")]
    pairs += _linear("fc2", "mano_regHead.mano_base_layer.2")
    for name in ("pose_reg", "shape_reg", "cam_reg"):
        pairs += _linear(name, f"mano_regHead.{name}")
    out: StateDict = {}
    _copy(out, sd, pairs)
    out["betas"] = _t(sd["hand_regHead.betas"]).reshape(-1)
    out["fc1.weight"] = _hwc_columns(
        _t(sd["mano_regHead.mano_base_layer.0.weight"]), 256, 2, 2)
    return out


def import_handoccnet_fpn(state_dict: Dict) -> StateDict:
    """HandOccNet's FPN backbone (a leaky ResNet-50 bottom-up path, the
    top-down laterals and smoothing convolutions, the spatial gate) -> the
    port ``FPN``'s."""
    sd = state_dict
    pairs = [("conv_stem.weight", "layer0.0.weight")] + _bn("bn_stem",
                                                            "layer0.1")
    for i, blocks in {1: 3, 2: 4, 3: 6, 4: 3}.items():
        for j in range(blocks):
            src, dst = f"layer{i}.0.{j}", f"layer{i}.{j}"
            for k in range(1, 4):
                pairs += [(f"{dst}.conv{k}.weight", f"{src}.conv{k}.weight")]
                pairs += _bn(f"{dst}.bn{k}", f"{src}.bn{k}")
            if f"{src}.downsample.0.weight" in sd:
                pairs += [(f"{dst}.down_conv.weight",
                           f"{src}.downsample.0.weight")]
                pairs += _bn(f"{dst}.bn_skip", f"{src}.downsample.1")
    for name in ("toplayer", "latlayer1", "latlayer2", "latlayer3",
                 "smooth2", "smooth3"):
        pairs += _conv(sd, name, name)
    pairs += [("gate.spatial_conv.weight",
               "attention_module.spatial.conv.weight")]
    pairs += _bn("gate.spatial_bn", "attention_module.spatial.bn")
    out: StateDict = {}
    _copy(out, sd, pairs)
    return out


def import_handoccnet_transformer(state_dict: Dict, depth: int = 2,
                                  injection: bool = True) -> StateDict:
    """HandOccNet's FIT (``injection``) or SET transformer -> the port
    ``InjectionTransformer``'s; the (1, C, H, W) q/k position maps become
    the port's (1, H, W, C)."""
    sd = state_dict
    out: StateDict = {}
    for i in range(depth):
        src, dst = f"layers.{i}", f"blocks.{i}"
        for emb in ("q_embedding", "k_embedding"):
            out[f"{dst}.{emb}"] = _t(sd[f"{src}.{emb}"]).permute(
                0, 2, 3, 1).contiguous()
        names = ["encode_value", "encode_query", "encode_key"]
        if injection:
            names += ["encode_query2", "encode_key2"]
        pairs = [p for n in names for p in _conv(sd, f"{dst}.{n}",
                                                 f"{src}.{n}")]
        pairs += [(f"{dst}.norm2.scale", f"{src}.norm2.weight"),
                  (f"{dst}.norm2.bias", f"{src}.norm2.bias")]
        pairs += (_linear(f"{dst}.fc1", f"{src}.mlp.fc1")
                  + _linear(f"{dst}.fc2", f"{src}.mlp.fc2"))
        _copy(out, sd, pairs)
    if injection:
        _copy(out, sd, _conv(sd, "conv1a", "conv1.0")
              + _conv(sd, "conv1b", "conv1.2") + _conv(sd, "conv2", "conv2.0"))
    return out


def import_handoccnet(state_dict: Dict) -> StateDict:
    """A whole HandOccNet checkpoint (backbone, FIT, SET, regressor, and
    where present the KPE MLP and the grasp classifier) -> the port
    ``HandOccNetNet``'s. MANO and the renderer hold no learned weights."""
    sd = state_dict
    out: StateDict = {}
    out.update(_prefixed(import_handoccnet_fpn(_sub(sd, "backbone.")), "fpn."))
    out.update(_prefixed(import_handoccnet_transformer(
        _sub(sd, "FIT."), injection=True), "fit."))
    out.update(_prefixed(import_handoccnet_transformer(
        _sub(sd, "SET."), injection=False), "set."))
    out.update(_prefixed(import_handoccnet_regressor(_sub(sd, "regressor.")),
                         "regressor."))
    if "kpe.feat_mlp.0.weight" in sd:
        _copy(out, sd, _linear("kpe_fc1", "kpe.feat_mlp.0")
              + _linear("kpe_fc2", "kpe.feat_mlp.2"))
    if "grasp_classifier.0.weight" in sd:
        out.update(_grasp(sd))
    return out
