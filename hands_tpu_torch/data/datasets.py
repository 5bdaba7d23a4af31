"""Host-side datasets producing :class:`Record` s (the port's own copy of
the parts of ``hands_tpu/data/datasets.py`` that serving and calibration
need): the robust image reader, the ``RecordDataset`` base and the synthetic
dataset. The real dataset classes are ROADMAP queue 1 item 4.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

from hands_tpu_torch.config import Config
from hands_tpu_torch.data.records import Record, default_flags

# sizes of the subsampled splits (reference dataset_utils.py:138-168)
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
    """Deterministic subsample of a file list for mini/small splits: python's
    Mersenne stream seeded at 1, as the reference selects its subsets."""
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


def _read_image(path: str, dummy_shape=(600, 840, 3), scale_denom: int = 1):
    """Robust image read through cv2: (RGB uint8 image, True), or a zero image
    and False on failure (a corrupt file must not kill a long run).
    ``scale_denom`` > 1 resizes after decode to the geometry of a scaled
    JPEG decode."""
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise IOError(path)
        img = img[:, :, ::-1]  # BGR -> RGB
        if scale_denom > 1:
            img = cv2.resize(
                img, (-(-img.shape[1] // scale_denom),
                      -(-img.shape[0] // scale_denom)),
                interpolation=cv2.INTER_AREA)
        return np.ascontiguousarray(img), True
    except Exception:  # any decode failure -> the dummy image, as documented
        d = scale_denom
        return np.zeros((-(-dummy_shape[0] // d), -(-dummy_shape[1] // d), 3),
                        np.uint8), False


class RecordDataset:
    """Base: a list of per-sample entries -> Record on demand."""

    name = "base"

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        self.samples = downsample(self._load_samples(), split)

    def _load_samples(self) -> List:
        raise NotImplementedError

    def _to_record(self, sample) -> Record:
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Record:
        return self._to_record(self.samples[idx])


class SyntheticRecordDataset(RecordDataset):
    """Schema-complete synthetic records with consistent MANO geometry: the
    no-download stand-in for tests, debug runs and calibration smoke runs."""

    name = "synthetic"
    _FLAGS = default_flags(j2d=1, j3d=1, pose=1, beta=1, cam=1, grasp=1,
                           mask=1)

    _SPLIT_LEN = {"minitrain": 12, "tinytrain": 4, "smalltrain": 32,
                  "minival": 6, "tinyval": 4, "smallval": 16}

    def __init__(self, cfg: Config, split: str = "train", length: int = None,
                 img_hw=(320, 427)):
        self.length = length or self._SPLIT_LEN.get(split, 64)
        self.img_hw = img_hw
        super().__init__(cfg, split)

    def _load_samples(self) -> List[dict]:
        # all labels from one MANO forward per hand (on the CPU: host data)
        import torch

        from hands_tpu_torch.ops import mano as manolib

        n = self.length
        rngs = [np.random.RandomState(1000 + i) for i in range(n)]
        H, W = self.img_hw
        K = np.asarray(
            [[800.0, 0, W / 2], [0, 800.0, H / 2], [0, 0, 1]], np.float32)

        self._labels = {}
        for side, is_r, x_off in (("r", True, 0.06), ("l", False, -0.06)):
            pose = np.stack([
                (r.randn(48) * 0.2).astype(np.float32) for r in rngs])
            beta = np.stack([
                (r.randn(10) * 0.3).astype(np.float32) for r in rngs])
            with torch.no_grad():
                out = manolib.mano_forward(
                    manolib.load_mano(is_r, device="cpu"),
                    torch.from_numpy(beta), torch.from_numpy(pose[:, 3:]),
                    torch.from_numpy(pose[:, :3]))
            j = out.joints.numpy()
            cam_t = np.asarray([x_off, 0.0, 0.55], np.float32)
            j3d = (j + cam_t).astype(np.float32)
            p = j3d @ K.T
            j2d = p[..., :2] / np.maximum(p[..., 2:], 1e-9)
            self._labels[side] = dict(pose=pose, beta=beta, j3d=j3d,
                                      j2d=j2d.astype(np.float32))
        self._K = K
        return [{"idx": i} for i in range(n)]

    def _to_record(self, s: dict) -> Record:
        i = s["idx"]
        rng = np.random.RandomState(1000 + i)
        # consume the same draws as label generation for deterministic images
        rng.randn(48), rng.randn(10)
        H, W = self.img_hw
        K = self._K
        lr, ll = self._labels["r"], self._labels["l"]
        pose_r, beta_r, j3d_r = lr["pose"][i], lr["beta"][i], lr["j3d"][i]
        pose_l, beta_l, j3d_l = ll["pose"][i], ll["beta"][i], ll["j3d"][i]
        j2d_r = pad_jts2d(lr["j2d"][i])
        j2d_l = pad_jts2d(ll["j2d"][i])

        img = (rng.rand(H, W, 3) * 60).astype(np.uint8)
        for j2 in (j2d_r, j2d_l):
            for x, y, _ in j2[::4]:
                xi, yi = int(x), int(y)
                if 1 <= xi < W - 1 and 1 <= yi < H - 1:
                    img[yi - 1:yi + 2, xi - 1:xi + 2] = 255

        return Record(
            imgname=f"synthetic/{i:06d}.jpg", image=img, K=K,
            j2d_r=j2d_r, j2d_l=j2d_l, j3d_r=j3d_r, j3d_l=j3d_l,
            pose_r=pose_r, pose_l=pose_l, beta_r=beta_r, beta_l=beta_l,
            grasp_r=int(rng.randint(0, 9)), grasp_l=int(rng.randint(0, 9)),
            grasp_valid_r=1.0, grasp_valid_l=1.0,
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# the JAX package's dataset names whose classes (and files) are not ported
_NOT_PORTED = ("hands", "arctic", "sample", "assembly", "epic", "epic_grasp",
               "epic_seg", "epic_depth", "ego_grasp", "ego_seg", "h2o",
               "egoexo")
DATASET_REGISTRY = {"synthetic": SyntheticRecordDataset}


def fetch_dataset(cfg: Config, names: str, split: str):
    """Resolve a dataset name into a dataset (port of ``fetch_dataset``).
    Only ``"synthetic"`` is ported; a real dataset name, alone or in an
    ``a+b+c`` mix, raises ``NotImplementedError``."""
    parts = names.split("+")
    for p in parts:
        if p in _NOT_PORTED:
            raise NotImplementedError(
                f"dataset '{p}' is not ported (its class, the native decoder "
                f"and the concatenation of datasets): ROADMAP queue 1 item 4")
        if p not in DATASET_REGISTRY:
            raise KeyError(f"unknown dataset '{p}'")
    if len(parts) > 1:
        raise NotImplementedError(
            "the concatenation of datasets is not ported: ROADMAP queue 1 "
            "item 4")
    return DATASET_REGISTRY[parts[0]](cfg, split)
