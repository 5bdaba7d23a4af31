"""The port's importers of released torch checkpoints
(``hands_tpu_torch.utils.torch_import``, ``cli.convert_ckpt``,
``train.checkpoint.graft_backbone_variables``) against the JAX package's.

Every importer reads a synthetic state dict in the reference's key layout
(seeded numpy draws, no file of released weights is needed). The JAX
importer maps it into a Flax tree, which goes into the matching scope of the
JAX model's variables and through ``utils.from_jax.state_dict_from_jax``;
the port's importer must give the same tensors under the same keys, bit for
bit. The position grid's bicubic resize is held to ``jax.image.resize`` at
1e-6 of the grid's scale. (``tests/test_torch_import.py`` is the JAX
package's own test of its importers.)
"""

import re

import numpy as np
import pytest
import torch

import jax

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_batch
from hands_tpu.models import registry as jax_registry
from hands_tpu.models.backbones import vit as jax_vit
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.utils import torch_import as jti
from hands_tpu_torch.cli.convert_ckpt import main as convert_main
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.backbones import vit as port_vit
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.train.checkpoint import graft_backbone_variables
from hands_tpu_torch.utils import torch_import as ti
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import fill_variables

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(rng, shape, key):
    if key.endswith("running_var"):
        a = rng.uniform(0.5, 1.5, shape)
    else:
        a = rng.randn(*shape) * 0.1
    return torch.from_numpy(a.astype(np.float32))


def resnet_reference_sd(stage_sizes, rng):
    """Random weights in torchvision's ResNet layout (basic blocks for
    (2, 2, 2, 2), bottlenecks otherwise)."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = _draw(rng, (cout, cin, k, k), name)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{leaf}"] = _draw(rng, (c,), f"{name}.{leaf}")

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    bottleneck = tuple(stage_sizes) != (2, 2, 2, 2)
    cin = 64
    for s, blocks in enumerate(stage_sizes):
        width = 64 * 2**s
        cout = width * (4 if bottleneck else 1)
        for b in range(blocks):
            pre = f"layer{s + 1}.{b}"
            c_in = cin if b == 0 else cout
            if bottleneck:
                convs = ((width, c_in, 1), (width, width, 3), (cout, width, 1))
            else:
                convs = ((cout, c_in, 3), (cout, cout, 3))
            for k, (o, i, ks) in enumerate(convs):
                conv(f"{pre}.conv{k + 1}", o, i, ks)
                bn(f"{pre}.bn{k + 1}", o)
            if b == 0 and (c_in != cout or s > 0):
                conv(f"{pre}.downsample.0", cout, c_in, 1)
                bn(f"{pre}.downsample.1", cout)
        cin = cout
    return sd


def vit_reference_sd(depth, C, hidden, n_tok, rng, cls_token=True):
    """Random weights in the ViTPose layout (a leading class token in the
    position embedding)."""
    sd = {"patch_embed.proj.weight": _draw(rng, (C, 3, 16, 16), ""),
          "patch_embed.proj.bias": _draw(rng, (C,), ""),
          "pos_embed": _draw(rng, (1, n_tok + int(cls_token), C), ""),
          "last_norm.weight": _draw(rng, (C,), ""),
          "last_norm.bias": _draw(rng, (C,), "")}
    for i in range(depth):
        for name, shape in (("norm1", (C,)), ("norm2", (C,)),
                            ("attn.qkv", (3 * C, C)), ("attn.proj", (C, C)),
                            ("mlp.fc1", (hidden, C)), ("mlp.fc2", (C, hidden))):
            sd[f"blocks.{i}.{name}.weight"] = _draw(rng, shape, "")
            sd[f"blocks.{i}.{name}.bias"] = _draw(rng, shape[:1], "")
    return sd


def reference_from_port(port_sd, rename, rng):
    """A reference-layout state dict with the shapes of ``port_sd``:
    ``rename(port key, shape)`` gives (reference key, reference shape), or
    None for entries the reference stores otherwise."""
    sd = {}
    for k, v in port_sd.items():
        got = rename(k, tuple(v.shape))
        if got is not None:
            sd[got[0]] = _draw(rng, got[1], got[0])
    return sd


def _resnet_name(k):
    k = k.replace("conv_stem", "conv1").replace("bn_stem", "bn1")
    k = re.sub(r"stages\.(\d)\.", lambda m: f"layer{int(m[1]) + 1}.", k)
    return k.replace("down_conv", "downsample.0").replace("down_bn",
                                                          "downsample.1")


def _jax_variables(model, inputs, meta, seed=1):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs,
                                               meta))
    return jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed))


def _with_scope(variables, scope, tree):
    """``variables`` with the JAX importer's ``tree`` in ``scope``."""
    out = {c: dict(v) for c, v in variables.items()}
    for col in ("params", "batch_stats"):
        if col in tree:
            out[col][scope] = jax.tree_util.tree_map(np.asarray, tree[col])
    return out


def _scope(port_sd, prefix):
    return {k[len(prefix):]: v for k, v in port_sd.items()
            if k.startswith(prefix)}


def assert_bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------ WildHands
@pytest.fixture(scope="module")
def hands():
    cfg_kw = dict(backbone="resnet18", compute_dtype="float32")
    jcfg = jax_config("hands_light", **cfg_kw)
    jmodel = jax_registry.fetch_model(jcfg)
    inputs, _, meta = jax_batch(jcfg, 1, seed=0)
    variables = _jax_variables(jmodel, inputs, meta)
    model = fetch_model(default_config("hands_light", **cfg_kw), "cpu")
    return variables, model


@pytest.mark.parametrize("stages", [(2, 2, 2, 2), (3, 4, 6, 3)])
def test_import_resnet_matches_jax(hands, stages):
    variables, model = hands
    sd = resnet_reference_sd(stages, np.random.RandomState(sum(stages)))
    got = ti.import_resnet(sd, stage_sizes=stages)
    if stages == (2, 2, 2, 2):
        want = _scope(state_dict_from_jax(_with_scope(
            variables, "hand_backbone", jti.import_resnet(sd, stages)),
            model), "net.hand_backbone.")
        assert_bit_equal(got, want)
    else:  # the bottleneck layout: against a ResNet-50 WildHands
        m50 = fetch_model(default_config("hands_light", compute_dtype="float32"),
                          "cpu")
        jcfg = jax_config("hands_light", compute_dtype="float32")
        inputs, _, meta = jax_batch(jcfg, 1, seed=0)
        v50 = _jax_variables(jax_registry.fetch_model(jcfg), inputs, meta)
        want = _scope(state_dict_from_jax(_with_scope(
            v50, "glb_backbone", jti.import_resnet(sd, stages)), m50),
            "net.glb_backbone.")
        assert_bit_equal(got, want)


def _trunk_name(k, shape):
    k = k[len("net."):]
    for scope, ref in (("hand_backbone.", "hand_backbone."),
                       ("glb_backbone.", "backbone.")):
        if k.startswith(scope):
            return ref + _resnet_name(k[len(scope):]), shape
    k = re.sub(r"cam_init\.(\d)", lambda m: f"cam_init.{2 * int(m[1])}", k)
    k = k.replace("hmr_layer.refine0", "hmr_layer.refine.0")
    k = k.replace("hmr_layer.refine1", "hmr_layer.refine.3")
    k = k.replace("hmr_layer.dec.cam_t_wp", "hmr_layer.decoders.cam_t/wp")
    k = k.replace("hmr_layer.dec.", "hmr_layer.decoders.")
    k = re.sub(r"feature_conv\.conv(\d)",
               lambda m: f"feature_conv.{2 * int(m[1])}", k)
    k = k.replace("feature_conv.dense", "feature_conv.7")
    k = re.sub(r"grasp_classifier\.layers\.(\d)",
               lambda m: f"grasp_classifier.{2 * int(m[1])}", k)
    return k, shape


def test_import_hands_trunk_matches_jax(hands):
    """The whole WildHands trunk (both ResNet-18s, the feature convolutions
    with their (C, H, W) -> (H, W, C) column permutation, both heads, the
    grasp classifier): every port entry, bit for bit."""
    _, model = hands
    sd = reference_from_port(model.state_dict(), _trunk_name,
                             np.random.RandomState(7))
    got = ti.import_hands_trunk(sd, backbone="resnet18")
    want = state_dict_from_jax(jti.import_hands_trunk(sd, "resnet18"), model)
    assert_bit_equal({f"net.{k}": v for k, v in got.items()}, want)


def test_graft_fills_both_wildhands_backbones(hands):
    _, model = hands
    model = fetch_model(model.cfg, "cpu", seed=2)
    sd = resnet_reference_sd((2, 2, 2, 2), np.random.RandomState(9))
    converted = ti.import_resnet(sd, stage_sizes=(2, 2, 2, 2))
    assert graft_backbone_variables(model, converted) == [
        "glb_backbone", "hand_backbone"]
    own = model.state_dict()
    for scope in ("glb_backbone", "hand_backbone"):
        for k, v in converted.items():
            assert torch.equal(own[f"net.{scope}.{k}"], v), k
    with pytest.raises(ValueError, match="no matching scope"):
        graft_backbone_variables(model, ti.import_resnet(
            resnet_reference_sd((3, 4, 6, 3), np.random.RandomState(1))))


# ---------------------------------------------------------------- HaMeR
@pytest.fixture(scope="module")
def hamer():
    jcfg = jax_config("hamer_light", compute_dtype="float32")
    jmodel = JaxHamer(jcfg, vit_variant="tiny")
    inputs, _, meta = jax_batch(jcfg, 1, seed=0)
    variables = _jax_variables(jmodel, inputs, meta)
    model = fetch_model(default_config("hamer_light", compute_dtype="float32"),
                        "cpu", vit_variant="tiny")
    return variables, model


def test_import_vit_matches_jax(hamer):
    variables, model = hamer
    sd = vit_reference_sd(2, 128, 256, 192, np.random.RandomState(3))
    got = ti.import_vit(sd, depth=2)
    want = _scope(state_dict_from_jax(_with_scope(
        variables, "backbone", jti.import_vit(sd, depth=2)), model),
        "net.backbone.")
    assert_bit_equal(got, want)
    pos = sd["pos_embed"]
    assert torch.equal(got["pos_embed"], pos[:, 1:] + pos[:, :1])


def test_import_hamer_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A released HaMeR file holds the depth-32 ViT under ``backbone.``:
    here at the tiny width (both packages' ``tiny`` made 32 deep)."""
    for configs in (jax_vit.VIT_CONFIGS, port_vit.VIT_CONFIGS):
        monkeypatch.setitem(configs, "tiny", dict(configs["tiny"], depth=32))
    sd = vit_reference_sd(32, 128, 256, 192, np.random.RandomState(5))
    path = str(tmp_path / "hamer.ckpt")
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in sd.items()}},
               path)
    jcfg = jax_config("hamer_light", compute_dtype="float32")
    inputs, _, meta = jax_batch(jcfg, 1, seed=0)
    variables = _jax_variables(JaxHamer(jcfg, vit_variant="tiny"), inputs,
                               meta)
    model = fetch_model(default_config("hamer_light", compute_dtype="float32"),
                        "cpu", vit_variant="tiny")
    want = _scope(state_dict_from_jax(_with_scope(
        variables, "backbone", jti.import_hamer_checkpoint(path)), model),
        "net.backbone.")
    assert_bit_equal(ti.import_hamer_checkpoint(path), want)
    # the converter writes the same, and it grafts into HaMeR's backbone
    out = str(tmp_path / "vit.pt")
    convert_main(["--src", path, "--arch", "hamer", "--out", out])
    converted = torch.load(out, weights_only=True)
    assert_bit_equal(converted, want)
    assert graft_backbone_variables(model, converted) == ["backbone"]


def _head_name(k, shape):
    if not k.startswith("net.mano_head."):
        return None
    k = k[len("net.mano_head."):]
    for a, b in (("token_proj", "transformer.to_token_embedding"),
                 ("pos_embedding", "transformer.pos_embedding")):
        if k.startswith(a):
            return k.replace(a, b), shape
    m = re.match(r"layers\.(\d+)\.(.*)", k)
    if m is None:
        return k, shape  # decpose, decshape, deccam
    pre, rest = f"transformer.transformer.layers.{m[1]}", m[2]
    norm = re.match(r"norm(\d)\.(scale|bias)", rest)
    if norm:
        leaf = "weight" if norm[2] == "scale" else "bias"
        return f"{pre}.{norm[1]}.norm.{leaf}", shape
    if rest.startswith("self_attn.to_q"):
        return f"{pre}.0.fn.to_qkv.weight", (3 * shape[0], shape[1])
    if rest.startswith("self_attn.to_kv"):
        return None  # rows two and three of to_qkv
    for a, b in (("self_attn.to_out", "0.fn.to_out.0"),
                 ("cross_attn.to_out", "1.fn.to_out.0"),
                 ("cross_attn.to_q", "1.fn.to_q"),
                 ("cross_attn.to_kv", "1.fn.to_kv"),
                 ("fc1", "2.fn.net.0"), ("fc2", "2.fn.net.3")):
        if rest.startswith(a):
            return f"{pre}.{rest.replace(a, b)}", shape
    raise KeyError(k)


def test_import_hamer_head_matches_jax(hamer):
    variables, model = hamer
    sd = reference_from_port(model.state_dict(), _head_name,
                             np.random.RandomState(11))
    got = ti.import_hamer_head(sd)
    want = _scope(state_dict_from_jax(_with_scope(
        variables, "mano_head", jti.import_hamer_head(sd)), model),
        "net.mano_head.")
    # the mean pose, shape and camera are the model's own buffers, as in
    # the JAX head (constants there); the importers carry the parameters
    mean = {k for k in want if k.startswith("mean_")}
    assert mean == {"mean_pose", "mean_betas", "mean_cam"}
    assert_bit_equal(got, {k: v for k, v in want.items() if k not in mean})


# ------------------------------------------------------------ HandOccNet
def _hocc_residual(rest, bns):
    m = re.match(r"(bn|conv)(\d)\.(.*)", rest)
    i = int(m[2])
    return (f"{bns[i]}.{m[3]}" if m[1] == "bn" else f"conv{i + 1}.{m[3]}")


_HG_LEVELS = {"hg": 3, "hg_d": 2, "hg_d_d": 1, "hg_d_d_d": 0}


def _hocc_name(k, shape):
    k = k[len("net."):]
    scope, rest = k.split(".", 1)
    if scope in ("kpe_fc1", "kpe_fc2"):
        return f"kpe.feat_mlp.{0 if scope == 'kpe_fc1' else 2}.{rest}", shape
    if scope == "grasp_classifier":
        m = re.match(r"layers\.(\d)\.(.*)", rest)
        return f"grasp_classifier.{2 * int(m[1])}.{m[2]}", shape
    if scope == "fpn":
        rest = re.sub(r"^layer([1-4])\.(\d+)\.", r"layer\1.0.\2.", rest)
        rest = rest.replace("conv_stem", "layer0.0").replace("bn_stem",
                                                             "layer0.1")
        rest = rest.replace("down_conv", "downsample.0").replace(
            "bn_skip", "downsample.1")
        rest = rest.replace("gate.spatial_conv",
                            "attention_module.spatial.conv")
        rest = rest.replace("gate.spatial_bn", "attention_module.spatial.bn")
        return f"backbone.{rest}", shape
    if scope in ("fit", "set"):
        pre = scope.upper()
        m = re.match(r"blocks\.(\d)\.(.*)", rest)
        if m is None:
            rest = {"conv1a": "conv1.0", "conv1b": "conv1.2",
                    "conv2": "conv2.0"}[rest.split(".")[0]] + "." + \
                rest.split(".")[1]
            return f"{pre}.{rest}", shape
        blk, leaf = f"{pre}.layers.{m[1]}", m[2]
        if leaf in ("q_embedding", "k_embedding"):
            return f"{blk}.{leaf}", (shape[0], shape[3], shape[1], shape[2])
        leaf = leaf.replace("norm2.scale", "norm2.weight")
        leaf = leaf.replace("fc1", "mlp.fc1").replace("fc2", "mlp.fc2")
        return f"{blk}.{leaf}", shape
    # the regressor
    m = re.match(r"hourglass\.res\.(hg(?:_d)*)_(up|low1|low3|mid)\.(.*)", rest)
    if m:
        j = {"up": 0, "low1": 1, "low3": 2}.get(m[2])
        src = ("hand_regHead.hg.0.hg.0.3.0" if m[2] == "mid"
               else f"hand_regHead.hg.0.hg.{_HG_LEVELS[m[1]]}.{j}.0")
        return f"regressor.{src}.{_hocc_residual(m[3], ('bn1', 'bn2', 'bn3'))}", shape
    m = re.match(r"res\.(.*)", rest)
    if m:
        return ("regressor.hand_regHead.res.0.0."
                f"{_hocc_residual(m[1], ('bn1', 'bn2', 'bn3'))}"), shape
    m = re.match(r"reg\.(\d)\.(.*)", rest)
    if m:
        return (f"regressor.hand_Encoder.reg.{m[1]}."
                f"{_hocc_residual(m[2], ('bn', 'bn1', 'bn2'))}"), shape
    name, leaf = rest.split(".", 1) if "." in rest else (rest, "")
    src = {"fc": "hand_regHead.fc.0.block.0",
           "fc_bn": "hand_regHead.fc.0.block.1",
           "score": "hand_regHead.score.0",
           "heatmap_conv": "hand_Encoder.heatmap_conv",
           "encoding_conv": "hand_Encoder.encoding_conv",
           "fc1": "mano_regHead.mano_base_layer.0",
           "fc2": "mano_regHead.mano_base_layer.2",
           "pose_reg": "mano_regHead.pose_reg",
           "shape_reg": "mano_regHead.shape_reg",
           "cam_reg": "mano_regHead.cam_reg"}.get(name)
    if name == "betas":
        return "regressor.hand_regHead.betas", (1,) + shape
    return f"regressor.{src}.{leaf}", shape


@pytest.fixture(scope="module")
def hocc():
    jcfg = jax_config("handoccnet_light", compute_dtype="float32")
    inputs, _, meta = jax_batch(jcfg, 1, seed=0)
    variables = _jax_variables(jax_registry.fetch_model(jcfg), inputs, meta)
    model = fetch_model(default_config("handoccnet_light",
                                       compute_dtype="float32"), "cpu")
    sd = reference_from_port(model.state_dict(), _hocc_name,
                             np.random.RandomState(13))
    return variables, model, sd


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("part", ["fpn", "fit", "set", "regressor"])
def test_import_handoccnet_parts_match_jax(hocc, part):
    variables, model, sd = hocc
    if part == "fpn":
        src, jtree = "backbone.", jti.import_handoccnet_fpn
        port = ti.import_handoccnet_fpn
    elif part == "regressor":
        src, jtree = "regressor.", jti.import_handoccnet_regressor
        port = ti.import_handoccnet_regressor
    else:
        inj = part == "fit"
        src = f"{part.upper()}."

        def jtree(s):
            return jti.import_handoccnet_transformer(s, injection=inj)

        def port(s):
            return ti.import_handoccnet_transformer(s, injection=inj)
    part_sd = _sub(sd, src)
    want = _scope(state_dict_from_jax(_with_scope(
        variables, part, jtree(part_sd)), model), f"net.{part}.")
    assert_bit_equal(port(part_sd), want)


def test_import_handoccnet_matches_jax_and_converts(hocc, tmp_path):
    """The whole network, bit for bit; ``cli.convert_ckpt --arch
    handoccnet`` writes it under ``net.``, and it loads into the model
    whole (``load_state_dict(strict=True)``)."""
    _, model, sd = hocc
    want = state_dict_from_jax(jti.import_handoccnet(sd), model)
    got = ti.import_handoccnet(sd)
    assert_bit_equal({f"net.{k}": v for k, v in got.items()}, want)
    src, out = str(tmp_path / "hocc.pth"), str(tmp_path / "hocc.pt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, src)
    convert_main(["--src", src, "--arch", "handoccnet", "--out", out])
    converted = torch.load(out, weights_only=True)
    assert_bit_equal(converted, want)
    model.load_state_dict(converted, strict=True)


# --------------------------------------------------------------- resizes
@pytest.mark.parametrize("src,dst", [((16, 12), (14, 14)),
                                     ((16, 12), (24, 18)),
                                     ((14, 14), (16, 12))])
def test_pos_grid_resize_matches_jax_bicubic(src, dst):
    """Keys' cubic with a = -0.5, half-pixel centres, antialiased where the
    grid shrinks: ``jax.image.resize(..., "bicubic")`` to 1e-6."""
    rng = np.random.RandomState(sum(src + dst))
    pos = rng.randn(1, src[0] * src[1], 96).astype(np.float32)
    want = np.asarray(jax.image.resize(pos.reshape(1, *src, 96),
                                       (1, *dst, 96), "bicubic"))
    got = ti.resize_pos_grid(torch.from_numpy(pos), src, dst).numpy()
    assert got.shape == (1, dst[0] * dst[1], 96)
    err = np.abs(got.reshape(want.shape) - want).max() / max(
        np.abs(want).max(), 1.0)
    assert err <= 1e-6, err
    # torch's own bicubic is another function (a = -0.75)
    other = torch.nn.functional.interpolate(
        torch.from_numpy(pos).reshape(1, *src, 96).permute(0, 3, 1, 2),
        size=dst, mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(other.numpy() - want).max() > 1e-3


def test_convert_vit_b16_resizes_to_the_target_grid(tmp_path):
    """``--arch vit_b16 --target_grid 14 14``: 12 blocks (here narrow), the
    class token folded, the 16 x 12 grid resized as the JAX importer does."""
    sd = vit_reference_sd(12, 32, 64, 192, np.random.RandomState(2))
    src, out = str(tmp_path / "b16.pth"), str(tmp_path / "b16.pt")
    torch.save(sd, src)
    convert_main(["--src", src, "--arch", "vit_b16", "--out", out,
                  "--target_grid", "14", "14"])
    got = torch.load(out, weights_only=True)
    want = jti.import_vit(sd, depth=12, target_grid=(14, 14),
                          src_grid=(16, 12))["params"]
    assert got["pos_embed"].shape == (1, 196, 32)
    np.testing.assert_allclose(got["pos_embed"].numpy(),
                               np.asarray(want["pos_embed"]), rtol=0,
                               atol=1e-6)
    assert torch.equal(got["blocks.11.mlp.fc2.weight"],
                       sd["blocks.11.mlp.fc2.weight"])
