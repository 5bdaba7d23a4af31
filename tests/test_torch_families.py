"""The model families and variants added to the port beside WildHands and
HaMeR, against the JAX package on the CPU: ArcticSF (ResNet-18, B = 2) and
HaMeR (tiny ViT, B = 2) with the ``dense_latent`` token embedding
(WildHands with ``vit_b_16``: test_torch_vit_b16.py). Every Flax leaf
is a numpy draw carried by ``utils.from_jax``; the dense angle maps are
numpy draws too.

Also: ``fetch_model`` builds every method of the JAX registry and its
aliases; ``cli.demo`` and ``cli.calibrate`` take every method; and the
resizes the new paths add (``ops/resize.py``): HandOccNet's crop to 256^2
in both directions and the dense embedding's (16, 16) -> (16, 12) shrink,
against ``jax.image.resize`` at 1e-6 of the map's scale.

Tolerances: f32 predictions 1e-4 of each output's scale (max(|ref|.max(),
1), ``test_torch_hands_light.RTOL``); bf16 ones at bf16 resolution, 2e-2 of
the scale (the JAX side compiled without excess precision).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.handoccnet_light import to_input
from hands_tpu_torch.models.registry import fetch_model, inference_pose
from hands_tpu_torch.ops.resize import resize
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import RTOL, fill_variables, max_rel

NO_EXCESS = {"xla_allow_excess_precision": False}
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_pair(method, cfg_kw, B, vit_variant=None, options=None):
    """Both models on one synthetic batch (plus dense angle maps where the
    config reads them): (JAX predictions, port predictions, port model)."""
    jcfg = jax_config(method, **cfg_kw)
    jmodel = (JaxHamer(jcfg, vit_variant=vit_variant) if vit_variant
              else jax_fetch_model(jcfg))
    inputs, _, meta = jax_make_batch(jcfg, B, seed=0)
    inputs = dict(inputs)
    if cfg_kw.get("pos_enc") == "dense_latent":
        rng = np.random.RandomState(3)
        for s in ("r", "l"):
            inputs[f"{s}_dense_angle"] = jnp.asarray(rng.uniform(
                -0.6, 0.6, (B, 224, 224, 2)).astype(np.float32))
            inputs[f"{s}_dense_mask"] = jnp.asarray(
                (rng.rand(B, 224, 224) > 0.2).astype(np.float32))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), inputs, meta))
    variables = jax.tree_util.tree_map(np.asarray,
                                       fill_variables(shapes, 1))
    fn = jax.jit(lambda v, i, m: dict(jmodel(v, i, m)))
    ref = fn.lower(variables, inputs, meta).compile(options)(
        variables, inputs, meta)
    kw = {"vit_variant": vit_variant} if vit_variant else {}
    model = fetch_model(default_config(method, **cfg_kw), "cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    tmeta = {k: torch.from_numpy(np.array(v)) for k, v in meta.items()}
    with torch.no_grad():
        got = model(tin, tmeta)
    return dict(ref), dict(got), model


def test_arctic_sf_matches_jax():
    """No crops: one global-image ResNet-18 feeds both hands' heads; grasp
    and render on (the method's defaults)."""
    ref, got, model = run_pair("arctic_sf_light",
                               dict(backbone="resnet18",
                                    compute_dtype="float32"), 2)
    assert type(model).__name__ == "ArcticSFLightModel"
    assert not hasattr(model.net, "hand_backbone")
    assert {"grasp.r", "render.l", "feat_vec"} <= set(ref)
    worst, per_key = max_rel(ref, got, per_tensor=True)
    assert worst <= RTOL, per_key


def test_hamer_dense_latent_matches_jax():
    """The per-token embedding of the dense angle map, resized to the
    (16, 12) token grid, added to the tokens and the features."""
    ref, got, model = run_pair("hamer_light",
                               dict(compute_dtype="float32",
                                    pos_enc="dense_latent"), 2,
                               vit_variant="tiny")
    assert model.net.kpe.fc1.weight.shape == (128, 16)
    worst, per_key = max_rel(ref, got, per_tensor=True)
    assert worst <= RTOL, per_key


@pytest.mark.parametrize("method", [
    "hands_light", "hands", "arctic_sf_light", "arctic_sf", "hamer_light",
    "hamer", "handoccnet_light", "handoccnet"])
def test_fetch_model_builds_every_method(method):
    kw = {"vit_variant": "tiny"} if method.startswith("hamer") else {}
    model = fetch_model(default_config(
        method if method.endswith("_light") else f"{method}_light"
    ).replace(method=method), "cpu", **kw)
    assert not model.training
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_fetch_model_draws_handoccnet_as_flax():
    """Flax's initialisers: N(0, 1) q/k position maps, unit heatmap
    temperatures, unit BatchNorm scales (no zeroed last scale: HandOccNet's
    bottlenecks keep Flax's default), lecun-normal kernels, zero biases."""
    sd = fetch_model(default_config("handoccnet_light"), "cpu",
                     seed=2).state_dict()
    q = sd["net.fit.blocks.0.q_embedding"]
    assert q.shape == (1, 32, 32, 256) and abs(float(q.std()) - 1.0) < 0.02
    assert bool((sd["net.regressor.betas"] == 1.0).all())
    assert bool((sd["net.fpn.layer1.0.bn3.weight"] == 1.0).all())
    w = sd["net.fpn.layer2.0.conv2.weight"]  # fan-in 128 * 9
    assert abs(float(w.std()) * (128 * 9) ** 0.5 - 1.0) < 0.05
    assert float(sd["net.fit.conv1a.bias"].abs().max()) == 0.0


def test_vit_b16_and_dense_latent_build_and_serve():
    """The ``vit_b_16`` WildHands and a ``dense_latent`` HaMeR through
    ``fetch_model`` + the preprocessing + ``inference_pose``."""
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from test_torch_hands_light import records

    for method, kw, vit in (("hands_light", dict(backbone="vit_b_16"), {}),
                            ("hamer_light", dict(pos_enc="dense_latent"),
                             {"vit_variant": "tiny"})):
        cfg = default_config(method, compute_dtype="float32", **kw)
        model = fetch_model(cfg, "cpu", **vit)
        inputs, _, meta = DevicePreprocessor(cfg, False, device="cpu")(
            stack_records(records()))
        out = inference_pose(model, inputs, meta)
        assert out["pred.mano.vertices.r"].shape == (2, 778, 3)
        assert bool(torch.isfinite(out["pred.render.l"]).all())


@pytest.mark.parametrize("method", ["arctic_sf_light", "handoccnet_light"])
def test_demo_serves_the_other_families(tmp_path, method):
    import cv2

    from hands_tpu_torch.cli.demo import main

    rng = np.random.RandomState(6)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"im{i}.png"),
                    rng.randint(0, 256, (200, 240, 3), np.uint8))
    out = tmp_path / "out"
    assert main(["--dir", str(tmp_path), "--method", method, "--device",
                 "cpu", "--out", str(out)],
                overrides={"backbone": "resnet18"}
                if method.startswith("arctic") else None) == 0
    pred = np.load(out / "im1_pred.npz")
    assert pred["pred.mano.vertices.l"].shape == (778, 3)


def test_calibrate_takes_every_method_and_finds_the_taps_jax_finds():
    """``cli.calibrate`` builds any method; the calibration taps sit on
    HaMeR's ViT blocks, so a WildHands model has none (the JAX calibrate
    finds no ``quant_stats`` there either)."""
    from hands_tpu_torch.cli import calibrate as cal

    cfg = cal.serving_config("handoccnet_light")
    assert cfg.method == "handoccnet_light" and cfg.compute_dtype == "bfloat16"
    assert cal.serving_config("hamer_vith").method == "hamer_light"
    _, model = cal.build_model("hands_light", "tiny", device="cpu",
                               backbone="resnet18")
    batches = cal.synthetic_batches(cal.serving_config("hands_light"), 1, 1,
                                    device="cpu")
    with pytest.raises(ValueError, match="no calibration taps"):
        cal.calibrate_scales("hands_light", model.state_dict(), batches,
                             device="cpu")


# --------------------------------------------------------------- resizes
@pytest.mark.parametrize("side", [224, 320, 160])
def test_handoccnet_crop_resize_matches_jax(side):
    """224 and 160 grow to 256 (no antialiasing); 320 shrinks (JAX
    antialiases: the triangle widened by 320 / 256)."""
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 256, 256, 3), "bilinear"))
    got = to_input(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    if side > 256:  # PyTorch's resize without antialiasing is another map
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(256, 256),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(plain.numpy() - want).max() > 1e-3


def test_dense_token_grid_shrink_matches_jax():
    x = np.random.RandomState(0).randn(3, 16, 16, 16).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (3, 16, 12, 16), "bilinear"))
    got = resize(torch.from_numpy(x), 16, 12, "bilinear").numpy()
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
