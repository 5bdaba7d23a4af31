"""Split bookkeeping and label helpers of the datasets (the port's own copy
of ``hands_tpu/data/dataset_utils.py``): the mini/tiny/small split sizes,
the seeded deterministic subsample with its RNG-stream guard (after
``Random(1)`` the first ``randint(0, 100)`` must be 17, which pins the
selected subset across Python versions), the 2D-joint padding, the remap of
labels into the pre-cropped ("speedup") images and the in-frame visibility
rule.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

# sizes of the subsampled splits
_SPLIT_SIZES = {
    "minitrain": 300, "tinytrain": 12000, "smalltrain": 100000,
    "minival": 80, "tinyval": 500, "smallval": 12000,
    "minitest": 200, "tinytest": 6000, "smalltest": 12000,
}


def get_num_images(split: str, num_images: int) -> int:
    if split in ("train", "val", "test"):
        return num_images
    if split in _SPLIT_SIZES:
        return min(_SPLIT_SIZES[split], num_images)
    raise ValueError(f"unknown split '{split}'")


def downsample(fnames: Sequence, split: str) -> List:
    """Deterministic subsample of a file list for mini/tiny/small splits:
    python's Mersenne stream seeded at 1, so the subset is always the same."""
    if "small" not in split and "mini" not in split and "tiny" not in split:
        return list(fnames)
    rng = random.Random(1)
    if rng.randint(0, 100) != 17:
        raise RuntimeError("RNG stream drift: split subsampling would differ "
                           "from the reference selection")
    fnames = list(fnames)
    return rng.sample(fnames, get_num_images(split, len(fnames)))


def pad_jts2d(jts: np.ndarray) -> np.ndarray:
    """(J, 2) -> (J, 3) with confidence 1 appended."""
    return np.concatenate([jts, np.ones((jts.shape[0], 1), jts.dtype)], axis=1)


def transform_kp2d_to_crop(kp2d: np.ndarray, bbox_cxcys) -> np.ndarray:
    """Full-image 2D keypoints -> the pre-cropped image's pixels: the crop
    is 1.5x the (cx, cy, scale) box's side, resized to 1000 px."""
    cx, cy, scale = bbox_cxcys
    s = 200 * scale
    factor = 1000.0 / (1.5 * s)
    out = kp2d.copy()
    out[:, 0] = (out[:, 0] - (cx - 1.5 / 2 * s)) * factor
    out[:, 1] = (out[:, 1] - (cy - 1.5 / 2 * s)) * factor
    return out


def transform_2d_for_speedup(speedup: bool, is_egocam: bool,
                             joints2d_r, joints2d_l, bbox_crop,
                             ego_image_scale: float):
    """Labels for the pre-cropped ("speedup") images: an egocentric image is
    downscaled uniformly by ``ego_image_scale``; a static camera's crop is
    resampled into a fixed 1000 px frame."""
    joints2d_r = np.copy(joints2d_r)
    joints2d_l = np.copy(joints2d_l)
    bbox_crop = list(bbox_crop)
    if speedup:
        if is_egocam:
            joints2d_r[:, :2] *= ego_image_scale
            joints2d_l[:, :2] *= ego_image_scale
            bbox_crop = [v * ego_image_scale for v in bbox_crop]
        else:
            joints2d_r = transform_kp2d_to_crop(joints2d_r, bbox_crop)
            joints2d_l = transform_kp2d_to_crop(joints2d_l, bbox_crop)
            bbox_crop = [500.0, 500.0, 1000.0 / (1.5 * 200)]
    return joints2d_r, joints2d_l, bbox_crop


def get_valid(j2d: np.ndarray, img_w: int, img_h: int, min_visible: int = 3):
    """Per-joint visibility (inside the frame) and the sample's validity
    (more than ``min_visible`` joints visible)."""
    vis = (
        (j2d[:, 0] >= 0) & (j2d[:, 0] < img_w)
        & (j2d[:, 1] >= 0) & (j2d[:, 1] < img_h)
    ).astype(np.float32)
    return vis, float(vis.sum() > min_visible)
