"""Port parity of ``ops/preprocess.py:mask_crop`` and of the mask and depth
targets of the eval-mode ``DevicePreprocessor`` against the JAX package's.

Nearest-neighbour crops pick one source pixel each, so a crop agrees exactly
unless a sample coordinate lies within one f32 ulp of a pixel boundary; the
test's boxes keep away from those. The binary mask targets are compared
exactly; depth targets and raw crops to 2e-4 absolute, the tolerance
test_torch_preprocess.py states for resampled images.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.data.records import Record, default_flags
from hands_tpu.ops import preprocess as jpp
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.device_pipeline import DevicePreprocessor
from hands_tpu_torch.data.device_pipeline import stack_records
from hands_tpu_torch.ops import preprocess as tpp

TOL = 2e-4
B, H, W, RES = 3, 90, 120, 64


def _crop_inputs(seed=0):
    rng = np.random.RandomState(seed)
    center = np.stack([rng.uniform(40, 80, B), rng.uniform(30, 60, B)],
                      -1).astype(np.float32) + 0.37
    bbox_dim = rng.uniform(0.31, 0.47, B).astype(np.float32)
    augm = {"sc": np.array([1.0, 1.13, 0.91], np.float32),
            "rot": np.zeros(B, np.float32)}
    return rng, center, bbox_dim, augm


@pytest.mark.parametrize("kind", ["mask_u8", "depth_f32", "channels"])
def test_mask_crop_matches_jax(kind):
    rng, center, bbox_dim, augm = _crop_inputs()
    if kind == "mask_u8":
        src = rng.choice([0, 127, 255], (B, H, W)).astype(np.uint8)
    elif kind == "depth_f32":
        src = rng.uniform(0.2, 3.0, (B, H, W)).astype(np.float32)
    else:
        src = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    ref = np.asarray(jpp.mask_crop(
        jnp.asarray(src), jnp.asarray(center), jnp.asarray(bbox_dim),
        {k: jnp.asarray(v) for k, v in augm.items()}, RES, apply_rot=False))
    got = tpp.mask_crop(
        torch.from_numpy(src), torch.from_numpy(center),
        torch.from_numpy(bbox_dim),
        {k: torch.from_numpy(v) for k, v in augm.items()}, RES)
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (B, RES, RES, src.shape[3:] and 2 or 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    if kind == "mask_u8":  # nearest: only source values, zero outside
        assert set(np.unique(got.numpy())) <= {0.0, 127.0, 255.0}


def test_mask_crop_rotation_pass():
    """The rotation pass was the last piece of ``mask_crop`` to port: with
    zero rotation it is the unrotated crop away from the border, with a
    rotation it moves the mask; a resampling method that does not exist
    still raises."""
    rng, center, bbox_dim, augm = _crop_inputs()
    args = (torch.from_numpy(center), torch.from_numpy(bbox_dim))
    at = {k: torch.from_numpy(v) for k, v in augm.items()}
    # blobs of 6 x 6 pixels: a pixel's neighbours mostly share its value
    masks = torch.from_numpy(np.kron(
        rng.choice([0, 127, 255], (B, H // 6, W // 6)),
        np.ones((6, 6))).astype(np.float32))
    flat = tpp.mask_crop(masks, *args, dict(at, rot=torch.zeros(B)), RES)
    same = tpp.mask_crop(masks, *args, dict(at, rot=torch.zeros(B)), RES,
                         apply_rot=True)
    assert same.shape == flat.shape == (B, RES, RES, 1)
    assert float((same != flat).float().mean()) < 0.05  # two nearest passes
    turned = tpp.mask_crop(masks, *args, dict(at, rot=torch.full((B,), 30.0)),
                           RES, apply_rot=True)
    assert float((turned != flat).float().mean()) > 0.05
    with pytest.raises(ValueError):
        tpp.crop_resize_separable(
            torch.zeros(B, H, W, 1), torch.from_numpy(center[:, 0]),
            torch.from_numpy(center[:, 1]), torch.from_numpy(bbox_dim), RES,
            method="cubic")


def _records(with_maps):
    rng = np.random.RandomState(1)
    recs = []
    for i in range(3):
        j2d = lambda lo, hi: np.concatenate(
            [rng.uniform(lo, hi, (21, 2)), np.ones((21, 1))],
            -1).astype(np.float32)
        mask = np.zeros((200, 240), np.uint8)
        mask[40 + 10 * i:120, 30:110] = 255
        mask[60:150, 130:200 + 5 * i] = 127
        kw = {}
        if with_maps:
            kw = dict(mask=mask,
                      depth=rng.uniform(0.3, 2.0, (200, 240)).astype(
                          np.float32))
        recs.append(Record(
            imgname=f"m{i}", image=rng.randint(0, 256, (200, 240, 3),
                                               np.uint8),
            K=np.asarray([[600.0, 0, 120], [0, 600.0, 100], [0, 0, 1]],
                         np.float32),
            j2d_r=j2d(40, 110), j2d_l=j2d(130, 200),
            bbox=np.asarray([120.3, 100.6, 1.1 + 0.07 * i], np.float32),
            mask_valid_r=1.0, mask_valid_l=float(i != 1),
            loss_flags=default_flags(), dataset="test", **kw))
    return recs


@pytest.mark.parametrize("with_maps", [True, False], ids=["maps", "no_maps"])
def test_preprocessor_mask_and_depth_targets_match_jax(with_maps):
    kw = dict(use_render_seg_loss=True, use_depth_loss=True,
              compute_dtype="float32")
    recs = _records(with_maps)
    _, ref, _ = JaxPre(jax_config("hands_light", **kw), is_train=False)(
        jax_stack(recs), jax.random.PRNGKey(0))
    _, got, _ = DevicePreprocessor(default_config("hands_light", **kw),
                                   is_train=False, device="cpu")(
        stack_records(recs))
    assert set(ref) == set(got)
    for k in ("render.r", "render.l"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
        assert (float(got[k].sum()) > 0) == with_maps, k
    for k in ("depth.r", "depth.l", "render_valid_r", "render_valid_l"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    assert got["render.r"].shape == (3, 224, 224)
    if with_maps:
        d = got["depth.r"].numpy()
        assert d.max() > 0.3 and (d == 0).any()  # clipped to the hand's box
        assert float(got["render_valid_l"][1]) == 0.0
