"""Port parity of WildHands under every ``pos_enc`` mode: the port's
``HandsLightModel`` against the JAX one (ResNet-18, 224^2, B = 2, f32,
weights and running statistics through ``from_jax``), and the port's
preprocessing of each mode's inputs against the JAX functions.

The model inputs of each mode are made by the JAX preprocessing functions
from the boxes and intrinsics of one JAX pipeline run (``pcl``'s virtual-
camera rotations by numpy: this file holds the model's handling of them;
the port's ``pcl`` preprocessing is held in test_torch_pcl.py). Tolerance
on every prediction, relative to max(|ref|, 1): 1e-4, as
test_torch_hands_light.py. Preprocessed KPE inputs:
4e-5 absolute (angles from the same f32 boxes agree to 1e-6; the pixel
coordinates behind ``cam_conv``'s offsets reach 224, where an f32 ulp is
1.5e-5, and the two ``linspace`` lattices differ by one or two).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.ops import preprocess as jpp
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                  stack_records)
from hands_tpu_torch.models import kpe as tkpe
from hands_tpu.models import kpe as jkpe
from test_torch_hands_light import RTOL, max_rel, records, run_pair


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs six workers side by side, and eight threads
    each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


MODES = [None, "center", "corner", "center+corner", "dense",
         "center+corner_latent", "sinusoidal_cc", "dense_latent", "cam_conv",
         "pcl", "perspective_correction"]


@pytest.fixture(scope="module")
def base():
    recs = records()
    cfg = jax_config("hands_light", backbone="resnet18")
    inputs, _, meta = JaxPre(cfg, is_train=False)(jax_stack(recs),
                                                  jax.random.PRNGKey(0))
    inputs = {k: np.asarray(v) for k, v in inputs.items()}
    meta = {"intrinsics": np.asarray(meta["intrinsics"]),
            "is_flipped": np.asarray(meta["is_flipped"])}
    return recs, inputs, meta


def _mode_inputs(mode, inputs, meta):
    """The model inputs of ``mode``, made by the JAX functions."""
    out = {k: inputs[k] for k in ("img", "r_img", "l_img")}
    K = jnp.asarray(meta["intrinsics"])
    for side in ("r", "l"):
        box = jnp.asarray(inputs[f"{side}_bbox"])
        if mode == "sinusoidal_cc":
            out[f"{side}_center_angle"] = jpp.kpe_center_coords(box, 224)
            out[f"{side}_corner_angle"] = jpp.kpe_corner_coords(box, 224)
        elif mode is not None:
            out[f"{side}_center_angle"] = jpp.kpe_center_angles(box, K)
            out[f"{side}_corner_angle"] = jpp.kpe_corner_angles(box, K)
        if mode == "cam_conv":
            a, m = jpp.kpe_camconv_dense(box, K, 224)
        elif mode in ("dense", "dense_latent"):
            a, m = jpp.kpe_dense_angles(box, K, 224)
        else:
            a = None
        if a is not None:
            out[f"{side}_dense_angle"], out[f"{side}_dense_mask"] = a, m
        if mode == "pcl":
            rng = np.random.RandomState(len(side) + ord(side))
            q, _ = np.linalg.qr(rng.randn(2, 3, 3))
            q = q * np.sign(np.linalg.det(q))[:, None, None]
            out[f"{side}_rot"] = q.astype(np.float32)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_pos_enc_mode_matches_jax(base, mode):
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False, pos_enc=mode)
    ref, got, model, _ = run_pair(kw, _mode_inputs(mode, inputs, meta), meta)
    worst, per_key = max_rel(ref, got)
    assert worst <= RTOL, per_key
    stem = model.net.hand_backbone.conv_stem.weight.shape[1]
    assert stem == {"center": 3 + 16, "corner": 3 + 64,
                    "center+corner": 3 + 80, "dense": 3 + 16}.get(mode, 3)


@pytest.mark.parametrize("mode", ["pcl", "perspective_correction"])
def test_rotation_fix_modes_change_the_global_orientation(base, mode):
    """Both modes rotate joint 0 after the heads; against ``pos_enc=None``
    on the same weights only the global orientation may move."""
    _, inputs, meta = base
    kw = dict(backbone="resnet18", use_render_seg_loss=False)
    _, got, _, _ = run_pair(dict(kw, pos_enc=mode),
                            _mode_inputs(mode, inputs, meta), meta,
                            with_ref=False)
    _, plain, _, _ = run_pair(dict(kw, pos_enc=None),
                              _mode_inputs(None, inputs, meta), meta,
                              with_ref=False)
    for side in ("r", "l"):
        a, b = got[f"mano.pose.{side}"], plain[f"mano.pose.{side}"]
        assert torch.equal(a[:, 1:], b[:, 1:])
        assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
        np.testing.assert_array_equal(got[f"mano.beta.{side}"].numpy(),
                                      plain[f"mano.beta.{side}"].numpy())


@pytest.mark.parametrize("mode", ["sinusoidal_cc", "center", "corner",
                                  "center+corner", "dense", "dense_latent",
                                  "cam_conv", "perspective_correction"])
def test_port_preprocessing_makes_the_mode_inputs(base, mode):
    """``DevicePreprocessor`` for each mode against the JAX functions on the
    port's own boxes and intrinsics."""
    recs, _, _ = base
    cfg = default_config("hands_light", backbone="resnet18", pos_enc=mode)
    inputs, targets, meta = DevicePreprocessor(cfg, False, device="cpu")(
        stack_records(recs))
    want = _mode_inputs(mode, {k: v.numpy() for k, v in inputs.items()
                               if isinstance(v, torch.Tensor)},
                        {"intrinsics": meta["intrinsics"].numpy()})
    keys = [k for k in want if k not in ("img", "r_img", "l_img")]
    assert keys and set(keys) <= set(inputs)
    assert ("r_dense_angle" in inputs) == (mode in ("dense", "dense_latent",
                                                    "cam_conv"))
    for k in keys:
        assert inputs[k].shape == want[k].shape, k
        np.testing.assert_allclose(inputs[k].numpy(), want[k], atol=4e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(targets["center.r"].numpy(),
                                  inputs["r_center_angle"].numpy())


@pytest.mark.parametrize("out_hw", [(7, 7), (28, 20), (1, 1), (5, 5)])
def test_kpe_map_encoders_match_jax(out_hw):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    ref = jkpe.resize_align_corners(jnp.asarray(x), *out_hw)
    got = tkpe.resize_align_corners(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    angle = (rng.rand(2, 9, 9, 2).astype(np.float32) - 0.5) * 2
    mask = (rng.rand(2, 9, 9) > 0.2).astype(np.float32)
    ref = jkpe.dense_pos_enc(jnp.asarray(angle), jnp.asarray(mask), 4,
                             out_hw[0])
    got = tkpe.dense_pos_enc(torch.from_numpy(angle), torch.from_numpy(mask),
                             4, out_hw[0])
    assert got.shape == (2, out_hw[0], out_hw[0], 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    enc = rng.randn(2, 12).astype(np.float32)
    np.testing.assert_array_equal(
        tkpe.broadcast_to_map(torch.from_numpy(enc), *out_hw).numpy(),
        np.asarray(jkpe.broadcast_to_map(jnp.asarray(enc), *out_hw)))
