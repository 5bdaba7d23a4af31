"""Port parity of the slice: WildHands (``hands_light``) serving and
evaluation forward, ResNet-18 at 224^2, B = 2, weights and running
statistics carried from the JAX model by ``hands_tpu_torch.utils.from_jax``.

Inputs are demo records built in numpy, preprocessed once by the JAX pipeline
and fed to both models; the inputs of the other ``pos_enc`` modes are made by
the JAX preprocessing functions from the same boxes and intrinsics (``pcl``'s
rotations by numpy). Every leaf of the JAX variable tree is a seeded numpy
draw: the zero-initialised last BatchNorm scale of each block, the gain-0.01
decoders, running means and variances (> 0) included.

Tolerance on every prediction (``mano.*``, ``grasp.*``, ``render.*``,
``depth.*``, ``center.*``, ``corner.*``, ``feat_vec``), relative to
max(|ref|, 1), f32: 1e-4 for ResNet-18 and 5e-4 for the one ResNet-50
case, inside the 1e-4 to 5e-3 that PARITY.md gives the BatchNorm
chain. ``render.*`` is compared against the JAX model run op by op
(``jax.disable_jit``) where noted: compiled, XLA:CPU fuses the splat's
two-term product with other multiply-adds and moves the mask by up to 1e-3
(test_torch_rasterizer.py).

The pos_enc sweep lives in test_torch_hands_light_modes.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.models.hands_light import HandsLightModel as JaxHands
from hands_tpu_torch.cli.demo import (make_record, pad_to_common_size, serve,
                                      serving_config)
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.hands_light import HandsLightModel
from hands_tpu_torch.models.registry import fetch_model, inference_pose
from hands_tpu_torch.ops import mano_lbs, rasterizer
from hands_tpu_torch.utils.from_jax import state_dict_from_jax

RTOL = 1e-4


def records():
    rng = np.random.RandomState(0)
    recs = []
    for i, ((h, w), rb) in enumerate([((240, 320), [40.3, 50.6, 200.2, 210.7]),
                                      ((300, 260), None)]):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        recs.append(make_record(
            f"img{i}.png", img,
            None if rb is None else np.asarray(rb, np.float32),
            np.asarray([10.2, 20.7, 120.4, 150.1], np.float32),
            focal=None if i == 0 else 900.0))
    pad_to_common_size(recs)
    return recs


def fill_variables(shapes, seed):
    """ShapeDtypeStruct tree -> a numpy draw for every leaf."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            a = rng.randn(*shape) / np.sqrt(int(np.prod(shape[:-1])))
            if "_layer']['dec_" in name and name.split("['")[-2][:-2] in (
                    "dec_pose_6d", "dec_shape", "dec_cam_t_wp"):
                a = a * 0.3  # visible, bounded refinement steps
        elif name.endswith("['scale']") or name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # biases, running means
            a = rng.randn(*shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def as_np(v):
    return np.array(v, np.float32)  # a writable copy


def run_pair(cfg_kw, inputs, meta, seed=1, compiler_options=None,
             with_ref=True):
    """Build both models for ``default_config("hands_light", **cfg_kw)`` (in
    f32 unless ``cfg_kw`` names the compute dtype), fill the JAX variables,
    carry them over, run both. Returns (ref, got, port model, variables);
    ``with_ref=False`` skips compiling and running the JAX model (ref is
    None) for a caller that reads the port's side only."""
    cfg_kw = dict({"compute_dtype": "float32"}, **cfg_kw)
    jcfg = jax_config("hands_light", **cfg_kw)
    jmodel = JaxHands(jcfg)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jin, jmeta))
    variables = fill_variables(shapes, seed)
    ref = None
    if with_ref:
        fn = jax.jit(lambda v, i, m: dict(jmodel(v, i, m)))
        ref = fn.lower(variables, jin, jmeta).compile(compiler_options)(
            variables, jin, jmeta)

    model = HandsLightModel(default_config("hands_light", **cfg_kw)).eval()
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(as_np(v)) for k, v in inputs.items()}
    tmeta = {k: torch.from_numpy(as_np(v)) for k, v in meta.items()}
    before = dict(mano_lbs.launches), dict(rasterizer.launches)
    with torch.no_grad():
        got = model(tin, tmeta)
    # CPU tensors: the twins ran, no kernel was launched
    assert before == (mano_lbs.launches, rasterizer.launches)
    return ref, got, model, variables


def max_rel(ref, got, skip=(), per_tensor=False):
    """Largest |ref - got| / max(|ref|, 1) over all keys, element by element,
    or with ``per_tensor`` against each tensor's largest magnitude."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    worst = {}
    for k in ref:
        if k.startswith(tuple(skip)):
            continue
        a, b = as_np(ref[k]), got[k].numpy()
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        scale = np.abs(a).max() if per_tensor else np.abs(a)
        worst[k] = float(np.max(np.abs(a - b) / np.maximum(scale, 1.0)))
    return max(worst.values()), worst


@pytest.fixture(scope="module")
def base():
    """Records, and the JAX pipeline's inputs and meta for the default
    (centre + corner) KPE inputs, as numpy."""
    recs = records()
    cfg = jax_config("hands_light", backbone="resnet18")
    inputs, _, meta = JaxPre(cfg, is_train=False)(jax_stack(recs),
                                                  jax.random.PRNGKey(0))
    keep = ("img", "r_img", "l_img", "r_center_angle", "l_center_angle",
            "r_corner_angle", "l_corner_angle", "r_bbox", "l_bbox")
    inputs = {k: np.asarray(v) for k, v in inputs.items() if k in keep}
    meta = {"intrinsics": np.asarray(meta["intrinsics"]),
            "is_flipped": np.asarray(meta["is_flipped"])}
    return recs, inputs, meta


def test_default_config_evaluation_forward_matches_jax(base):
    """``default_config("hands_light")`` but ResNet-18: render and grasp on.
    ``render.*`` is held against the op-by-op JAX run."""
    _, inputs, meta = base
    ref, got, model, variables = run_pair(dict(backbone="resnet18"), inputs,
                                          meta)
    assert model.cfg.use_render_seg_loss and model.cfg.use_grasp_loss
    assert got["render.r"].shape == (2, 224, 224)
    assert got["grasp.l"].shape == (2, 9)
    assert got["mano.vertices.r"].shape == (2, 778, 3)
    assert got["feat_vec"].shape == (2, 512)
    worst, per_key = max_rel(ref, got, skip=("render.",))
    assert worst <= RTOL, per_key
    # compiled JAX render: the fused splat moves by up to 1e-3
    assert max_rel({k: ref[k] for k in ("render.r", "render.l")},
                   {k: got[k] for k in ("render.r", "render.l")})[0] <= 2e-3
    # the mask is a hand-sized blob, not empty and not full
    assert 0.005 < float(got["render.r"].mean()) < 0.9

    # op by op, the render agrees to the kernel test's 2e-5
    from hands_tpu.ops.rasterizer import render_silhouette as jrender
    jK = jnp.asarray(meta["intrinsics"])
    with jax.disable_jit():
        for side in ("r", "l"):
            want = jrender(jnp.asarray(as_np(ref[f"mano.v3d.cam.{side}"])),
                           None, jK, 224)
            mine = rasterizer.render_silhouette(
                torch.from_numpy(as_np(ref[f"mano.v3d.cam.{side}"])), None,
                torch.from_numpy(as_np(meta["intrinsics"])), 224)
            np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                       atol=2e-5)


@pytest.mark.parametrize("cfg_kw", [
    dict(tf_decoder=True),
    dict(separate_hands=True),
    dict(no_crops=True),
    dict(use_glb_feat=False, use_depth_loss=True, regress_center_corner=True),
], ids=["tf_decoder", "separate_hands", "no_crops", "depth_center_corner"])
def test_variants_match_jax(base, cfg_kw):
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False, **cfg_kw)
    ref, got, model, _ = run_pair(kw, inputs, meta)
    worst, per_key = max_rel(ref, got)
    assert worst <= RTOL, per_key
    if cfg_kw.get("use_depth_loss"):
        assert got["depth.r"].shape == (2, 224, 224)
        assert got["corner.l"].shape == (2, 8)
        assert "feat_vec" not in got
        assert float(got["depth.r"].abs().max()) > 1e-3


def test_flip_swap_with_mixed_flags_matches_jax(base):
    """Sample 0 flipped, sample 1 not: the swap, the mirrored poses and
    translations against the JAX model, and against the unflipped run."""
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False)
    flipped = dict(meta, is_flipped=np.asarray([1.0, 0.0], np.float32))
    ref, got, _, _ = run_pair(kw, inputs, flipped)
    worst, per_key = max_rel(ref, got)
    assert worst <= RTOL, per_key
    _, plain, _, _ = run_pair(kw, inputs, meta, with_ref=False)
    # sample 1 is untouched; sample 0's right hand is the mirrored left one
    np.testing.assert_array_equal(got["mano.beta.r"][1].numpy(),
                                  plain["mano.beta.r"][1].numpy())
    np.testing.assert_array_equal(got["mano.beta.r"][0].numpy(),
                                  plain["mano.beta.l"][0].numpy())
    t_r, t_l = got["mano.cam_t.wp.r"][0], plain["mano.cam_t.wp.l"][0]
    np.testing.assert_allclose(t_r.numpy(),
                               (t_l * torch.tensor([1.0, -1.0, 1.0])).numpy())
    assert not torch.equal(got["mano.pose.r"][0], plain["mano.pose.l"][0])


def test_resnet50_default_width_matches_jax(base):
    """The shipped width: ResNet-50 for both backbones, render off (held
    above), grasp on."""
    _, inputs, meta = base
    ref, got, model, _ = run_pair(dict(use_render_seg_loss=False), inputs,
                                  meta)
    assert model.cfg.backbone == "resnet50"
    assert got["feat_vec"].shape == (2, 2048)
    worst, per_key = max_rel(ref, got)
    assert worst <= 5e-4, per_key


def test_bf16_backbones_match_jax(base):
    """``compute_dtype="bfloat16"`` (the config's default): bf16 ResNets and
    ``FeatureConv``, f32 heads. The JAX side is compiled with
    ``xla_allow_excess_precision=False`` so that it keeps its bf16 roundings
    (XLA:CPU otherwise skips them inside fusions). A rounding that falls the
    other way in one of 17 layers is a bf16 ulp (2^-8) of a map value,
    whatever the size of the element it lands on, and is carried into the
    heads: so each output is held against its tensor's largest magnitude.
    Vertices and joints: 2e-2 (observed 5.6e-3). All outputs: 6e-2 (observed
    4.9e-2 in ``mano.pose.r``, 2.3e-2 or less elsewhere), which is the size
    of the JAX model's own bf16-against-f32 drift on these weights (5.4e-2
    in ``mano.pose.r``): the test's decoders have 30 times the gain of the
    Flax initialiser and amplify a bf16 ulp of the feature vector so far."""
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False,
              compute_dtype="bfloat16")
    ref, got, model, _ = run_pair(
        kw, inputs, meta,
        compiler_options={"xla_allow_excess_precision": False})
    assert model.net.dtype == torch.bfloat16
    assert model.net.hand_backbone.conv_stem.weight.dtype == torch.float32
    worst, per_key = max_rel(ref, got, per_tensor=True)
    assert worst <= 6e-2, per_key
    for k, v in per_key.items():
        if any(p in k for p in ("vertices", "joints3d", "v3d.", "j3d.")):
            assert v <= 2e-2, (k, v)
    _, exact, _, _ = run_pair(dict(kw, compute_dtype="float32"), inputs, meta,
                              with_ref=False)
    assert not torch.equal(got["mano.vertices.r"], exact["mano.vertices.r"])


def test_from_jax_consumes_every_leaf_and_fills_every_buffer(base):
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False)
    _, _, model, variables = run_pair(kw, inputs, meta, with_ref=False)
    sd = state_dict_from_jax(variables, model)
    assert set(sd) == set(model.state_dict())
    assert any(k.endswith("running_var") for k in sd)
    extra = {"params": dict(variables["params"], stray={"kernel": np.ones(2)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_jax(extra, model)
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": variables["params"]}, model)


def test_serve_end_to_end_matches_jax_pipeline_and_model(base):
    """The port's whole serving flow on the CPU (records -> port
    preprocessing -> port model, render and grasp off as the demo serves)
    against the JAX pipeline and model."""
    recs, inputs, meta = base
    cfg = serving_config("hands_light", "float32").replace(backbone="resnet18")
    assert cfg.compute_dtype == "float32"
    kw = dict(backbone="resnet18", use_render_seg_loss=False,
              use_grasp_loss=False)
    ref, _, model, _ = run_pair(kw, inputs, meta)
    out = serve(recs, cfg, model, "cpu")
    got = {k[len("pred."):]: v for k, v in out.items()
           if k.startswith("pred.")}
    assert "grasp.r" not in got and "render.r" not in got
    worst, per_key = max_rel(ref, got)
    assert worst <= RTOL, per_key


def test_fetch_model_and_evaluation_entry_points():
    """``fetch_model`` + ``DevicePreprocessor`` + ``inference_pose`` with the
    config's defaults (render and grasp on) on the CPU; the seeded
    initialisation follows Flax's rules."""
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    cfg = default_config("hands_light", backbone="resnet18",
                         compute_dtype="float32")
    model = fetch_model(cfg, device="cpu", seed=3)
    assert not model.training
    sd = model.state_dict()
    bn = "net.hand_backbone.stages.1.0."
    assert float(sd[bn + "bn1.weight"].min()) == 1.0
    assert float(sd[bn + "bn2.weight"].abs().max()) == 0.0  # last of block
    assert float(sd[bn + "down_bn.weight"].min()) == 1.0
    assert float(sd[bn + "bn1.running_var"].min()) == 1.0
    dec = sd["net.head_r.hmr_layer.dec.pose_6d.weight"]
    bound = 0.01 * (6.0 / (1024 + 96)) ** 0.5
    assert 0.9 * bound < float(dec.abs().max()) <= bound
    conv = sd[bn + "conv1.weight"]  # lecun-normal: std 1/sqrt(64*9)
    assert abs(float(conv.std()) * (64 * 9) ** 0.5 - 1.0) < 0.05
    assert float(sd["net.head_r.cam_init.0.bias"].abs().max()) == 0.0

    pre = DevicePreprocessor(cfg, is_train=False, device="cpu")
    inputs, targets, meta = pre(stack_records(records()))
    assert float(targets["render.r"].abs().max()) == 0.0  # no masks: zeros
    assert targets["render_valid_r"].shape == (2,)
    out = inference_pose(model, inputs, meta)
    for k in ("pred.render.r", "pred.render.l", "pred.grasp.r",
              "pred.grasp.l", "pred.mano.vertices.l", "pred.feat_vec"):
        assert bool(torch.isfinite(out[k]).all()), k
    assert out["pred.render.l"].shape == (2, 224, 224)

    # the ViT-B/16 backbone builds and serves the same inputs
    vit = fetch_model(cfg.replace(backbone="vit_b_16"), device="cpu", seed=3)
    vout = inference_pose(vit, inputs, meta)
    assert vout["pred.mano.vertices.r"].shape == (2, 778, 3)
    assert bool(torch.isfinite(vout["pred.render.l"]).all())
    # pcl preprocesses: perspective crops and the rotations the model reads
    pcl, _, _ = DevicePreprocessor(cfg.replace(pos_enc="pcl"), False,
                                   device="cpu")(stack_records(records()))
    assert pcl["r_img"].shape == inputs["r_img"].shape
    assert pcl["r_rot"].shape == pcl["l_rot"].shape == (2, 3, 3)


def test_demo_command_line_serves_wildhands_by_default(tmp_path):
    """``python -m hands_tpu_torch.cli.demo`` without ``--method`` serves
    ``hands_light`` (as the JAX demo), here on the CPU with seeded weights."""
    import cv2

    from hands_tpu_torch.cli.demo import run_demo

    rng = np.random.RandomState(5)
    for i, shape in enumerate([(200, 240, 3), (220, 200, 3), (180, 260, 3)]):
        cv2.imwrite(str(tmp_path / f"im{i}.png"),
                    rng.randint(0, 256, shape, np.uint8))
    out = tmp_path / "out"
    rc = run_demo(["--dir", str(tmp_path), "--batch_size", "2", "--device",
                   "cpu", "--out", str(out), "--r_bbox", "20,30,150,170"])
    assert rc == 0
    pred = np.load(out / "im2_pred.npz")
    assert pred["pred.mano.vertices.r"].shape == (778, 3)
    assert pred["pred.feat_vec"].shape == (2048,)  # two ResNet-50s
    assert np.isfinite(pred["pred.mano.j3d.cam.l"]).all()
    with pytest.raises(SystemExit):  # --method takes the registry's four
        run_demo(["--dir", str(tmp_path), "--method", "nope"])
