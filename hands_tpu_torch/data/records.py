"""Host-side sample records: the contract between datasets and the device
pipeline (the port's own copy of ``hands_tpu/data/records.py``).

A *record* is the minimal per-sample payload a dataset must produce on the
host (decoded image + labels + camera). Everything geometric/augmentation
(cropping, warping, KPE, normalisation) happens later, batched, on device —
the inversion of the reference's per-sample cv2 ``__getitem__``
(``src/datasets/hands_light_dataset.py:25-508``).

Fields follow the reference's label semantics; ``loss_flags`` carries the
per-dataset supervision routing (§2.2 of SURVEY.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

LOSS_FLAGS = (
    "is_j2d_loss", "is_j3d_loss", "is_pose_loss", "is_beta_loss",
    "is_cam_loss", "is_grasp_loss", "is_mask_loss", "is_depth_loss",
)


@dataclass
class Record:
    imgname: str
    image: np.ndarray  # (H, W, 3) uint8/float, full image (or speedup crop)
    K: np.ndarray  # (3, 3) intrinsics in `image` pixel space
    # 2D joints in `image` pixel space, (21, 3) [x, y, conf]; zeros if absent
    j2d_r: np.ndarray = None
    j2d_l: np.ndarray = None
    # 3D joints in camera space (21, 3); zeros if absent
    j3d_r: np.ndarray = None
    j3d_l: np.ndarray = None
    # MANO params (48,) aa + (10,); zeros if absent
    pose_r: np.ndarray = None
    pose_l: np.ndarray = None
    beta_r: np.ndarray = None
    beta_l: np.ndarray = None
    # scene bbox driving the full-image patch: (cx, cy, scale/200px)
    bbox: np.ndarray = None
    # optional detected hand boxes in `image` pixel space, (4,) [x0,y0,x1,y1]
    # (reference epic_dataset.py:165-195: consumed when use_gt_bbox=False)
    r_bbox: Optional[np.ndarray] = None
    l_bbox: Optional[np.ndarray] = None
    # hand-box source: 0 -> boxes from GT joints (+train jitter), 1 -> the
    # provided r_bbox/l_bbox (grasp/seg/depth datasets and the EPIC
    # detected-box test path; a missing provided box means a full-image crop,
    # reference crop_and_pad None branch, data_utils.py:495-501)
    bbox_mode: float = 0.0
    # per-record camera semantics (reference per-dataset __getitem__ quirks):
    # is_egocam forces augm sc=1.0 on device ("no scaling for egocam to make
    # intrinsics consistent", hands_light_dataset.py:113-116);
    # use_gt_k: 1 -> crop-adjusted GT K, 0 -> weak-persp K with `wp_focal`,
    # None -> follow cfg.use_gt_k / cfg.focal_length (epic_dataset.py:238-249
    # scales the wp focal by img_res/max(W, H))
    is_egocam: float = 0.0
    use_gt_k: Optional[float] = None
    wp_focal: Optional[float] = None
    # (8,) egocam distortion coefficients (hands_light_dataset.py:470-473;
    # NaN for non-ego views)
    dist: Optional[np.ndarray] = None
    # aux labels
    grasp_r: int = 8  # 8 == "no grasp" (epic_grasp_dataset.py:43-52)
    grasp_l: int = 8
    mask: Optional[np.ndarray] = None  # (H, W) hand mask, R=255/L=127 coding
    depth: Optional[np.ndarray] = None  # (H, W) metric depth
    # validity
    right_valid: float = 1.0
    left_valid: float = 1.0
    is_valid: float = 1.0
    joints_valid_r: np.ndarray = None  # (21,) 2D visibility
    joints_valid_l: np.ndarray = None
    # (21,) per-joint 3D validity (EgoExo: drives the masked-Procrustes eval,
    # reference eval_modules.py:231-317); None for dense-GT datasets
    joints3d_valid_r: Optional[np.ndarray] = None
    joints3d_valid_l: Optional[np.ndarray] = None
    grasp_valid_r: float = 0.0
    grasp_valid_l: float = 0.0
    mask_valid_r: float = 0.0
    mask_valid_l: float = 0.0
    # supervision routing
    loss_flags: Dict[str, float] = field(default_factory=dict)
    dataset: str = ""

    def __post_init__(self):
        H = self.image.shape[0] if self.image is not None else 224
        W = self.image.shape[1] if self.image is not None else 224
        z21_3 = lambda: np.zeros((21, 3), np.float32)  # noqa: E731
        if self.j2d_r is None:
            self.j2d_r = z21_3()
        if self.j2d_l is None:
            self.j2d_l = z21_3()
        if self.j3d_r is None:
            self.j3d_r = z21_3()
        if self.j3d_l is None:
            self.j3d_l = z21_3()
        if self.pose_r is None:
            self.pose_r = np.zeros(48, np.float32)
        if self.pose_l is None:
            self.pose_l = np.zeros(48, np.float32)
        if self.beta_r is None:
            self.beta_r = np.zeros(10, np.float32)
        if self.beta_l is None:
            self.beta_l = np.zeros(10, np.float32)
        if self.bbox is None:
            self.bbox = np.asarray(
                [W / 2, H / 2, max(H, W) / 200.0], np.float32
            )
        if self.joints_valid_r is None:
            self.joints_valid_r = np.full(21, self.right_valid, np.float32)
        if self.joints_valid_l is None:
            self.joints_valid_l = np.full(21, self.left_valid, np.float32)
        if self.dist is None:
            self.dist = np.full(8, np.nan, np.float32)
        for flag in LOSS_FLAGS:
            self.loss_flags.setdefault(flag, 0.0)


def default_flags(**on) -> Dict[str, float]:
    flags = {k: 0.0 for k in LOSS_FLAGS}
    for k, v in on.items():
        key = k if k.startswith("is_") else f"is_{k}_loss"
        flags[key] = float(v)
    return flags
