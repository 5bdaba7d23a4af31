"""Host-side datasets producing :class:`Record` s (the port's own copy of
``hands_tpu/data/datasets.py``): the ten dataset families, the synthetic
dataset, ``a+b+c`` mixes and the robust image reader.

Each class keeps the label semantics of its counterpart in the upstream
project: file layouts, supervision flags, joint conventions and per-dataset
camera quirks; the geometry is left to the on-device preprocessor. Label
files are read from ``$DATA_DIR`` (default ``./data``) at the upstream
project's relative paths; a dataset whose files are absent raises
``DataNotFoundError`` with the path it expected.

Supervision flags:

| dataset      | j2d | j3d | pose | beta | cam | grasp | mask | depth |
|--------------|-----|-----|------|------|-----|-------|------|-------|
| hands/arctic |  1  |  1  |  1   |  1   |  1  |   0   |  0   |   0   |
| sample, h2o  |  1  |  1  |  1   |  1   |  1  |   0   |  0   |   0   |
| assembly     |  1  |  1  |  0   |  0   |  0  |   0   |  0   |   0   |
| epic (eval)  |  1  |  0  |  0   |  0   |  0  |   0   |  0   |   0   |
| egoexo       |  1  |  1  |  0   |  0   |  0  |   0   |  0   |   0   |
| *_grasp      |  0  |  0  |  0   |  0   |  0  |   1   |  0   |   0   |
| *_seg        |  0  |  0  |  0   |  0   |  0  |   0   |  1   |   0   |
| epic_depth   |  0  |  0  |  0   |  0   |  0  |   0   |  0   |   1   |

Per-record camera semantics: ``is_egocam`` (the augmentation's scale forced
to 1), ``use_gt_k`` (1: the crop-adjusted ground-truth K; 0: a
weak-perspective K at ``wp_focal``; None: ``cfg.use_gt_k``), and for the
in-the-wild egocentric sets ``wp_focal = focal_length * img_res / max(W,
H)``.
"""

from __future__ import annotations

import json
import os
import os.path as op
import pickle
import threading
from typing import List

import numpy as np

from hands_tpu_torch.config import Config
from hands_tpu_torch.data import dataset_utils as du
from hands_tpu_torch.data.records import Record, default_flags

# per-hand mean MANO betas from the reference val set, used as dummy shape
# targets by every dataset without MANO GT (epic_dataset.py:229-230,
# assembly_dataset.py:446-447, ego_exo_dataset.py:216-217, *_seg, *_depth)
MEAN_BETA_R = np.asarray(
    [0.82747316, 0.13775729, -0.39435294, 0.17889787, -0.73901576,
     0.7788163, -0.5702684, 0.4947751, -0.24890041, 1.5943261], np.float32)
MEAN_BETA_L = np.asarray(
    [-0.19330633, -0.08867972, -2.5790455, -0.10344583, -0.71684015,
     -0.28285977, 0.55171007, -0.8403888, -0.8490544, -1.3397144], np.float32)


class DataNotFoundError(FileNotFoundError):
    pass


def _data_dir() -> str:
    return os.environ.get("DATA_DIR", "./data")


def _require(path: str, what: str) -> str:
    if not os.path.exists(path):
        raise DataNotFoundError(
            f"{what} not found at '{path}' — set $DATA_DIR to a tree with the "
            f"reference layout (see hands_tpu_torch/data/datasets.py)"
        )
    return path


def _cv2_read(path: str, scale_denom: int):
    """cv2's decode, RGB. A JPEG at ``scale_denom`` 2, 4 or 8 goes through
    libjpeg's scaled iDCT (``IMREAD_REDUCED_COLOR_*``), the pixels of the
    native route; another file is resized after its decode."""
    import cv2

    reduced = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
               8: cv2.IMREAD_REDUCED_COLOR_8}
    with open(path, "rb") as f:
        is_jpeg = f.read(3) == b"\xff\xd8\xff"
    if is_jpeg and scale_denom in reduced:
        img = cv2.imread(path, reduced[scale_denom])
        scale_denom = 1
    else:
        img = cv2.imread(path)
    if img is None:
        raise IOError(path)
    img = img[:, :, ::-1]  # BGR -> RGB
    if scale_denom > 1:
        img = cv2.resize(
            img, (-(-img.shape[1] // scale_denom),
                  -(-img.shape[0] // scale_denom)),
            interpolation=cv2.INTER_AREA)
    return np.ascontiguousarray(img)


def image_decoder() -> str:
    """The route :func:`_read_image` takes on this machine: ``native``
    (libjpeg/libpng through ``utils/native.py``), ``cv2``, or ``none`` (every
    read then gives the zero image with ``ok=False``)."""
    from hands_tpu_torch.utils import native

    if native.available():
        return "native"
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "none"
    return "cv2"


def _read_image(path: str, dummy_shape=(600, 840, 3), scale_denom: int = 1):
    """Robust image read: (RGB uint8 image, True), or a zero image and False
    for a file that cannot be read (a corrupt file must not end a long run).
    The native libjpeg/libpng decoder where it builds, cv2 otherwise.
    ``scale_denom`` > 1 decodes at 1/denom of the size (a JPEG through the
    scaled iDCT)."""
    try:
        from hands_tpu_torch.utils import native

        if native.available():
            img = native.read_image(path, scale_denom)
            if img is None:
                raise IOError(path)
            return img, True
        return _cv2_read(path, scale_denom), True
    except Exception:  # any decode failure -> the dummy image, as documented
        d = scale_denom
        return np.zeros((-(-dummy_shape[0] // d), -(-dummy_shape[1] // d), 3),
                        np.uint8), False

def _wp_focal(cfg: Config, img_w: float, img_h: float) -> float:
    """In-the-wild weak-perspective focal: the fixed focal scaled into patch
    space (epic_dataset.py:238 — f * img_res / max(W, H))."""
    return cfg.focal_length * cfg.img_res / max(img_w, img_h)


def _centered_bbox(img_w: float, img_h: float) -> np.ndarray:
    """Full-image centred (cx, cy, scale/200) box used by all in-the-wild
    datasets (epic_dataset.py:80)."""
    return np.asarray([img_w / 2.0, img_h / 2.0, max(img_w, img_h) / 200.0],
                      np.float32)


class RecordDataset:
    """Base: a list of per-sample entries -> Record on demand."""

    name = "base"

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        self.samples = du.downsample(self._load_samples(), split)

    def _load_samples(self) -> List:
        raise NotImplementedError

    def _to_record(self, sample) -> Record:
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Record:
        return self._to_record(self.samples[idx])


# ------------------------------------------------------------------- ARCTIC
class HandsLightDataset(RecordDataset):
    """ARCTIC with full MANO GT (reference ``hands_light_dataset.py``).

    Split npy ``arctic/data/arctic_data/data/splits/{setup}_{split}.npy``
    holds ``{"data_dict": {sid/seq: {...}}, "imgnames": [...]}`` with
    per-sequence arrays indexed ``[vidx, view_idx]``; per-subject intrinsics,
    image sizes and frame offsets come from ``meta/misc.json``
    (hands_light_dataset.py:528-574). View 0 is egocentric: per-frame
    ``K_ego`` intrinsics, distortion coefficients, augm sc forced to 1; exo
    views use ``intris_mat[view-1]`` and the configured use_gt_k.

    The speedup path (parser.py:52, default ON) reads pre-cropped
    ``cropped_images/`` and remaps 2D labels + the crop bbox
    (dataset_utils.transform_2d_for_speedup_light:90): ego images are
    uniformly downscaled by ``ego_image_scale`` (K is scaled to match), exo
    crops land in a fixed 1000px frame.
    """

    name = "hands"
    _FLAGS = default_flags(j2d=1, j3d=1, pose=1, beta=1, cam=1)

    def _load_samples(self) -> List[str]:
        base = op.join(_data_dir(), "arctic/data/arctic_data/data")
        short = (self.split.replace("mini", "").replace("tiny", "")
                 .replace("small", ""))
        split_p = _require(
            op.join(base, f"splits/{self.cfg.setup}_{short}.npy"),
            "ARCTIC split file",
        )
        data = np.load(split_p, allow_pickle=True).item()
        self.data_dict = data["data_dict"]
        misc = json.load(open(_require(op.join(base, "meta/misc.json"),
                                       "ARCTIC misc.json")))
        self.intris_mat = {s: m["intris_mat"] for s, m in misc.items()}
        self.image_sizes = {s: m["image_size"] for s, m in misc.items()}
        self.ioi_offset = {s: m["ioi_offset"] for s, m in misc.items()}
        self.base = base
        return list(data["imgnames"])

    def _to_record(self, imgname: str) -> Record:
        cfg = self.cfg
        sid, seq_name, view, image_idx = imgname.split("/")[-4:]
        view_idx = int(view)
        seq_data = self.data_dict[f"{sid}/{seq_name}"]
        data_cam = seq_data["cam_coord"]
        data_2d = seq_data["2d"]
        data_params = seq_data["params"]
        vidx = int(image_idx.split(".")[0]) - self.ioi_offset[sid]

        is_valid = float(data_cam["is_valid"][vidx, view_idx])
        right_valid = float(data_cam["right_valid"][vidx, view_idx])
        left_valid = float(data_cam["left_valid"][vidx, view_idx])

        is_egocam = view_idx == 0
        if is_egocam:
            K = np.asarray(data_params["K_ego"][vidx], np.float32).copy()
        else:
            K = np.asarray(self.intris_mat[sid][view_idx - 1], np.float32)

        j2d_r = du.pad_jts2d(
            np.asarray(data_2d["joints.right"][vidx, view_idx], np.float32))
        j2d_l = du.pad_jts2d(
            np.asarray(data_2d["joints.left"][vidx, view_idx], np.float32))
        j3d_r = np.asarray(data_cam["joints.right"][vidx, view_idx], np.float32)
        j3d_l = np.asarray(data_cam["joints.left"][vidx, view_idx], np.float32)

        # global orient in this view's camera frame + hand articulation
        # (hands_light_dataset.py:208-212)
        pose_r = np.concatenate([
            np.asarray(data_cam["rot_r_cam"][vidx, view_idx], np.float32),
            np.asarray(data_params["pose_r"][vidx], np.float32)])
        pose_l = np.concatenate([
            np.asarray(data_cam["rot_l_cam"][vidx, view_idx], np.float32),
            np.asarray(data_params["pose_l"][vidx], np.float32)])
        beta_r = np.asarray(data_params["shape_r"][vidx], np.float32)
        beta_l = np.asarray(data_params["shape_l"][vidx], np.float32)
        dist = np.asarray(data_params["dist"][vidx], np.float32)

        bbox = np.asarray(seq_data["bbox"][vidx, view_idx], np.float32)
        j2d_r, j2d_l, bbox = du.transform_2d_for_speedup(
            cfg.speedup, is_egocam, j2d_r, j2d_l, bbox, cfg.ego_image_scale)
        if cfg.speedup and is_egocam:
            # labels and pixels now live in the downscaled image; scale the
            # intrinsics to match so the on-device crop-adjusted K equals the
            # reference's full-res get_aug_intrix result
            K = K.copy()
            K[:2] *= cfg.ego_image_scale

        subdir = "cropped_images" if cfg.speedup else "images"
        img, ok = _read_image(
            op.join(self.base, subdir, sid, seq_name, view, image_idx),
            dummy_shape=(2800, 2000, 3),
        )
        return Record(
            imgname=imgname, image=img, K=K,
            j2d_r=j2d_r, j2d_l=j2d_l, j3d_r=j3d_r, j3d_l=j3d_l,
            pose_r=pose_r, pose_l=pose_l, beta_r=beta_r, beta_l=beta_l,
            bbox=bbox,
            is_valid=is_valid * float(ok),
            right_valid=right_valid * is_valid,
            left_valid=left_valid * is_valid,
            is_egocam=float(is_egocam),
            use_gt_k=1.0 if is_egocam else None,  # exo follows cfg.use_gt_k
            dist=dist if is_egocam else None,  # NaN for non-ego (L:470-473)
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


class ArcticDataset(HandsLightDataset):
    name = "arctic"


class SampleDataset(RecordDataset):
    """Documented data-format template (reference ``sample_dataset.py`` +
    ``scripts_method/sample_data.py``): loads ``sample_data/samples.pkl`` —
    a pickled list of dicts with the Record fields. Use this as the I/O spec
    when adding a new dataset."""

    name = "sample"
    _FLAGS = default_flags(j2d=1, j3d=1, pose=1, beta=1, cam=1)

    def _load_samples(self) -> List[dict]:
        p = _require(
            op.join(_data_dir(), "sample_data/samples.pkl"),
            "sample dataset pickle",
        )
        with open(p, "rb") as f:
            return pickle.load(f)

    def _to_record(self, s: dict) -> Record:
        img, ok = _read_image(op.join(_data_dir(), "sample_data",
                                      s["imgname"]))
        return Record(
            imgname=s["imgname"], image=img, K=np.asarray(s["K"], np.float32),
            j2d_r=s.get("j2d_r"), j2d_l=s.get("j2d_l"),
            j3d_r=s.get("j3d_r"), j3d_l=s.get("j3d_l"),
            pose_r=s.get("pose_r"), pose_l=s.get("pose_l"),
            beta_r=s.get("beta_r"), beta_l=s.get("beta_l"),
            is_valid=float(ok), use_gt_k=1.0,
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# ----------------------------------------------------------------- Assembly
class AssemblyDataset(RecordDataset):
    """AssemblyHands with COCO-format annotations, v1-1
    (reference ``assembly_dataset.py:130-290``): per-annotation entries from
    ``assembly/annotations/{mode}/assemblyhands_{mode}_ego_{data,calib}_v1-1
    .json`` + ``_joint_3d_v1-1.json``; world-space joints (mm) are mapped to
    camera space per view, reindexed with the assembly->MANO tables, and
    converted to metres. 2D/3D joints only — no MANO params."""

    name = "assembly"
    ANNOT_VERSION = "v1-1"
    _FLAGS = default_flags(j2d=1, j3d=1)
    # assembly -> MANO joint reindex (assembly_dataset.py:144-147)
    JOINT_TYPE_R = np.asarray(
        [20, 7, 6, 5, 11, 10, 9, 19, 18, 17, 15, 14, 13, 3, 2, 1, 0, 4, 8,
         12, 16])
    JOINT_TYPE_L = np.asarray(
        [41, 28, 27, 26, 32, 31, 30, 40, 39, 38, 36, 35, 34, 24, 23, 22, 21,
         25, 29, 33, 37])

    def _load_samples(self) -> List[dict]:
        mode = (self.split.replace("mini", "").replace("tiny", "")
                .replace("small", ""))
        base = op.join(_data_dir(), "assembly")
        ann_dir = _require(op.join(base, "annotations", mode),
                           "AssemblyHands annotations")
        v = self.ANNOT_VERSION
        data = json.load(open(_require(
            op.join(ann_dir, f"assemblyhands_{mode}_ego_data_{v}.json"),
            "assembly data json")))
        calib = json.load(open(op.join(
            ann_dir, f"assemblyhands_{mode}_ego_calib_{v}.json")))["calibration"]
        joints = json.load(open(op.join(
            ann_dir, f"assemblyhands_{mode}_joint_3d_{v}.json")))["annotations"]
        images = {im["id"]: im for im in data["images"]}
        samples = []
        for ann in data["annotations"]:
            img = images[ann["image_id"]]
            samples.append({"ann": ann, "img": img, "calib": calib,
                            "joints": joints, "base": base})
        return samples

    def _to_record(self, s: dict) -> Record:
        cfg = self.cfg
        img_info, ann = s["img"], s["ann"]
        seq, cam = str(img_info["seq_name"]), img_info["camera"]
        frame = int(img_info["frame_idx"])
        fname = img_info["file_name"]
        W, H = float(img_info["width"]), float(img_info["height"])
        calib_seq = s["calib"][seq]
        K = np.asarray(calib_seq["intrinsics"][cam + "_mono10bit"],
                       np.float32)[:3, :3]
        Rt = np.asarray(calib_seq["extrinsics"][f"{frame:06d}"][
            cam + "_mono10bit"], np.float32)
        jw = np.asarray(s["joints"][seq][f"{frame:06d}"]["world_coord"],
                        np.float32).reshape(42, 3)
        jc = jw @ Rt[:3, :3].T + Rt[:3, 3]  # mm, camera space
        j2 = jc @ K.T
        j2 = j2[:, :2] / np.maximum(j2[:, 2:], 1e-9)
        jv = np.asarray(ann["joint_valid"], np.float32).reshape(42)

        def bbox_xyxy(key):
            bb = ann.get("bbox", {}).get(key)
            return None if bb is None else np.asarray(bb, np.float32)

        r_ann_bbox, l_ann_bbox = bbox_xyxy("right"), bbox_xyxy("left")
        img, ok = _read_image(op.join(s["base"], "images", fname),
                              dummy_shape=(int(H), int(W), 3))
        right_valid = float(r_ann_bbox is not None)
        left_valid = float(l_ann_bbox is not None)
        return Record(
            imgname=fname, image=img, K=K,
            j2d_r=du.pad_jts2d(j2[self.JOINT_TYPE_R].astype(np.float32)),
            j2d_l=du.pad_jts2d(j2[self.JOINT_TYPE_L].astype(np.float32)),
            j3d_r=(jc[self.JOINT_TYPE_R] / 1000.0).astype(np.float32),
            j3d_l=(jc[self.JOINT_TYPE_L] / 1000.0).astype(np.float32),
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(W, H),
            # ann boxes consumed only when GT-joint boxes are disabled
            r_bbox=None if cfg.use_gt_bbox else r_ann_bbox,
            l_bbox=None if cfg.use_gt_bbox else l_ann_bbox,
            bbox_mode=0.0 if cfg.use_gt_bbox else 1.0,
            joints_valid_r=jv[self.JOINT_TYPE_R],
            joints_valid_l=jv[self.JOINT_TYPE_L],
            right_valid=right_valid, left_valid=left_valid,
            is_valid=float(ok), is_egocam=1.0, use_gt_k=1.0,
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# --------------------------------------------------------------------- EPIC
# Assembly-order -> MANO-order joint reindex (epic_dataset.py:57)
_ASSEMBLY_TO_MANO = np.asarray(
    [20, 7, 6, 5, 11, 10, 9, 19, 18, 17, 15, 14, 13, 3, 2, 1, 0, 4, 8, 12, 16]
)


class EPICDataset(RecordDataset):
    """EPIC-HandKps evaluation set (reference ``epic_dataset.py``):
    ``epic_hands/hands_5000.pkl`` (test) / ``hands_250.pkl`` (val); only 2D
    supervision; dummy MANO params with mean betas; a hand is valid iff more
    than 3 annotated joints; with ``--use_gt_bbox`` off on the test split,
    detected boxes come from ``epic_hands/grasp_visor_val.pkl``."""

    name = "epic"
    _FLAGS = default_flags(j2d=1)
    IMG_W, IMG_H = 1920.0, 1080.0  # epic_dataset.py:78

    def _pkl_name(self):
        return "hands_250.pkl" if "val" in self.split else "hands_5000.pkl"

    def _load_samples(self) -> List[dict]:
        p = _require(
            op.join(_data_dir(), "epic_hands", self._pkl_name()),
            "EPIC-HandKps pickle",
        )
        with open(p, "rb") as f:
            data = pickle.load(f)
        bbox_data = {}
        if "test" in self.split and not self.cfg.use_gt_bbox:
            bp = _require(
                op.join(_data_dir(), "epic_hands/grasp_visor_val.pkl"),
                "EPIC detected-bbox pickle")
            with open(bp, "rb") as f:
                bbox_data = pickle.load(f)
            keys = set(data.keys()) & set(bbox_data.keys())
            data = {k: data[k] for k in data if k in keys}
        return [{"key": k, "ann": v, "bbox": bbox_data.get(k)}
                for k, v in data.items()]

    def _img_path(self, key: str) -> str:
        return key if op.isabs(key) else op.join(_data_dir(), key)

    def _to_record(self, s: dict) -> Record:
        ann = s["ann"]
        ds = max(1, int(self.cfg.decode_downscale))
        img, ok = _read_image(self._img_path(s["key"]),
                              dummy_shape=(2800, 2000, 3), scale_denom=ds)

        def hand(side):
            d = ann.get(side)
            if d is None:
                return (du.pad_jts2d(np.zeros((21, 2), np.float32)),
                        np.zeros(21, np.float32), 0.0)
            kp = np.asarray(d["joints"], np.float32).reshape(21, 2) / ds
            jv = np.asarray(d["joints_valid"], np.float32).reshape(21)
            kp = kp[_ASSEMBLY_TO_MANO]
            jv = jv[_ASSEMBLY_TO_MANO]
            return du.pad_jts2d(kp), jv, float(jv.sum() > 3)

        j2d_r, jv_r, val_r = hand("right")
        j2d_l, jv_l, val_l = hand("left")
        det = s.get("bbox") or {}

        def det_bbox(key):
            bb = det.get(key)
            return None if bb is None else np.asarray(bb, np.float32) / ds

        return Record(
            imgname=s["key"], image=img,
            K=np.eye(3, dtype=np.float32),
            j2d_r=j2d_r, j2d_l=j2d_l,
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(self.IMG_W / ds, self.IMG_H / ds),
            r_bbox=det_bbox("right_bbox"), l_bbox=det_bbox("left_bbox"),
            bbox_mode=1.0 if ("test" in self.split
                              and not self.cfg.use_gt_bbox) else 0.0,
            right_valid=val_r, left_valid=val_l,
            joints_valid_r=jv_r * val_r, joints_valid_l=jv_l * val_l,
            is_valid=float(ok),
            is_egocam=1.0, use_gt_k=0.0,
            wp_focal=_wp_focal(self.cfg, self.IMG_W, self.IMG_H),
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


class EPICGraspDataset(RecordDataset):
    """VISOR grasp-taxonomy labels (reference ``epic_grasp_dataset.py``):
    ``epic_hands/grasp_visor_train.pkl`` maps image path ->
    ``{right_grasp, left_grasp, right_bbox, left_bbox}``; 8 grasp classes +
    'no grasp'=8; hand crops come from the detected boxes; grasp loss only."""

    name = "epic_grasp"
    _FLAGS = default_flags(grasp=1)
    IMG_W, IMG_H = 1920.0, 1080.0
    # reference grasp taxonomy (epic_grasp_dataset.py:42-51)
    GRASP_LABELS = {
        "NP-Palm": 0, "NP-Fin": 1, "Pow-Pris": 2, "Pre-Pris": 3,
        "Pow-Circ": 4, "Pre-Circ": 5, "Later": 6, "Other": 7,
    }

    def _pkl_path(self):
        return op.join(_data_dir(), "epic_hands/grasp_visor_train.pkl")

    def _load_samples(self) -> List[dict]:
        p = _require(self._pkl_path(), f"{self.name} pickle")
        with open(p, "rb") as f:
            data = pickle.load(f)
        return [{"key": k, "ann": v} for k, v in data.items()]

    def _img_path(self, key: str) -> str:
        return key if op.isabs(key) else op.join(_data_dir(), key)

    def _image_size(self, img):
        return float(self.IMG_W), float(self.IMG_H)

    def _to_record(self, s: dict) -> Record:
        ann = s["ann"]
        img, ok = _read_image(self._img_path(s["key"]),
                              dummy_shape=(2800, 2000, 3))
        W, H = self._image_size(img)

        def label(side):
            g = ann.get(f"{side}_grasp")
            if g is None:
                return 8
            if isinstance(g, str):
                return self.GRASP_LABELS.get(g, 7)
            return int(g)

        def det_bbox(side):
            bb = ann.get(f"{side}_bbox")
            return None if bb is None else np.asarray(bb, np.float32)

        r_bbox, l_bbox = det_bbox("right"), det_bbox("left")
        gv_r = float(r_bbox is not None)
        gv_l = float(l_bbox is not None)
        return Record(
            imgname=s["key"], image=img, K=np.eye(3, dtype=np.float32),
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(W, H),
            r_bbox=r_bbox, l_bbox=l_bbox, bbox_mode=1.0,
            grasp_r=label("right"), grasp_l=label("left"),
            grasp_valid_r=gv_r, grasp_valid_l=gv_l,
            right_valid=gv_r, left_valid=gv_l, is_valid=float(ok),
            joints_valid_r=np.zeros(21, np.float32),
            joints_valid_l=np.zeros(21, np.float32),
            is_egocam=1.0, use_gt_k=0.0,
            wp_focal=_wp_focal(self.cfg, W, H),
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


class Ego4DGraspDataset(EPICGraspDataset):
    """Ego4D grasp labels (reference ``ego_grasp_dataset.py``:
    ``ego4d_hands/grasp_ego.pkl``; image size read from the frame)."""

    name = "ego_grasp"

    def _pkl_path(self):
        return op.join(_data_dir(), "ego4d_hands/grasp_ego.pkl")

    def _image_size(self, img):
        return float(img.shape[1]), float(img.shape[0])


class EPICSegDataset(RecordDataset):
    """VISOR hand masks (reference ``epic_seg_dataset.py``): value-coded
    masks (R=255 / L=127) from ``epic_hands/visor_pred_masks_train.npz``
    (``visor_masks_train.npz`` with use_gt_hand_mask), modal/amodal labels
    from ``modal_amodal_annot.pkl``, detected boxes from
    ``grasp_visor_train.pkl``; each hand's mask is clipped to its detected
    box region (L:138-144); mask loss only."""

    name = "epic_seg"
    _FLAGS = default_flags(mask=1)
    IMG_W, IMG_H = 1920.0, 1080.0

    def _paths(self):
        base = op.join(_data_dir(), "epic_hands")
        masks = ("visor_masks_train.npz"
                 if self.cfg.get("use_gt_hand_mask", False)
                 else "visor_pred_masks_train.npz")
        return (op.join(base, "modal_amodal_annot.pkl"),
                op.join(base, "grasp_visor_train.pkl"),
                op.join(base, masks))

    def _load_samples(self) -> List[dict]:
        modal_p, bbox_p, masks_p = self._paths()
        with open(_require(modal_p, f"{self.name} modal/amodal pickle"),
                  "rb") as f:
            modal = pickle.load(f)
        with open(_require(bbox_p, f"{self.name} bbox pickle"), "rb") as f:
            bbox = pickle.load(f)
        self.masks_npz = np.load(_require(masks_p, f"{self.name} masks npz"),
                                 allow_pickle=True)
        # one zip handle serves the loader's fetch threads: read under a lock
        self._masks_lock = threading.Lock()
        keys = sorted(set(modal) & set(bbox) & set(self.masks_npz.files))
        return [{"key": k, "modal": modal[k], "bbox": bbox[k]} for k in keys]

    def _img_path(self, key: str) -> str:
        return key if op.isabs(key) else op.join(_data_dir(), key)

    def _image_size(self, img):
        return float(self.IMG_W), float(self.IMG_H)

    def _to_record(self, s: dict) -> Record:
        img, ok = _read_image(self._img_path(s["key"]),
                              dummy_shape=(2800, 2000, 3))
        W, H = self._image_size(img)
        with self._masks_lock:
            mask = np.asarray(self.masks_npz[s["key"]])
        if mask.ndim == 3:
            mask = mask[..., 0]  # only the R channel is value-coded
        modal = dict(s["modal"]) if isinstance(s["modal"], dict) else {}
        ann = s["bbox"]

        def det_bbox(side):
            bb = ann.get(f"{side}_bbox")
            return None if bb is None else np.asarray(bb, np.float32)

        r_bbox, l_bbox = det_bbox("right"), det_bbox("left")
        right_valid = float(r_bbox is not None)
        left_valid = float(l_bbox is not None)

        # clip each hand's mask to its detected box region
        # (epic_seg_dataset.py:138-144), recombined value-coded
        coded = np.zeros(mask.shape, np.float32)

        def clip_region(value, bb):
            if bb is None:
                return
            x0, y0, x1, y1 = np.asarray(bb, np.int32)
            region = np.zeros_like(mask, bool)
            region[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
            coded[(mask == value) & region] = value

        clip_region(255, r_bbox)
        clip_region(127, l_bbox)

        # modal==1 means the hand is unoccluded -> mask is usable
        # (reference L:500-501 crosses the sides — a bug we do not replicate)
        mv_r = float(modal.get("right", 0) == 1) * right_valid
        mv_l = float(modal.get("left", 0) == 1) * left_valid
        return Record(
            imgname=s["key"], image=img, K=np.eye(3, dtype=np.float32),
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(W, H),
            r_bbox=r_bbox, l_bbox=l_bbox, bbox_mode=1.0,
            mask=coded, mask_valid_r=mv_r, mask_valid_l=mv_l,
            right_valid=right_valid, left_valid=left_valid,
            is_valid=float(ok),
            joints_valid_r=np.zeros(21, np.float32),
            joints_valid_l=np.zeros(21, np.float32),
            is_egocam=1.0, use_gt_k=0.0,
            wp_focal=_wp_focal(self.cfg, W, H),
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


class Ego4DSegDataset(EPICSegDataset):
    """Ego4D masks (reference ``ego_seg_dataset.py``:
    ``ego4d_hands/ego_blur_pred_masks.npz`` + ``grasp_ego.pkl`` boxes)."""

    name = "ego_seg"

    def _paths(self):
        base = op.join(_data_dir(), "ego4d_hands")
        return (op.join(base, "modal_amodal_annot.pkl"),
                op.join(base, "grasp_ego.pkl"),
                op.join(base, "ego_blur_pred_masks.npz"))

    def _image_size(self, img):
        return float(img.shape[1]), float(img.shape[0])


class EPICDepthDataset(RecordDataset):
    """ZoeDepth pseudo-GT (reference ``epic_depth_dataset.py``): 16-bit pngs
    in ``visor_depth/`` named by frame id, mm -> m, boxes from
    ``grasp_visor_train.pkl``; per-hand depth targets are the patch depth
    clipped to each hand's crop box (L:181-190); depth loss only."""

    name = "epic_depth"
    _FLAGS = default_flags(depth=1)
    IMG_W, IMG_H = 1920.0, 1080.0

    def _load_samples(self) -> List[dict]:
        bbox_p = _require(
            op.join(_data_dir(), "epic_hands/grasp_visor_train.pkl"),
            f"{self.name} bbox pickle")
        with open(bbox_p, "rb") as f:
            bbox = pickle.load(f)
        depth_dir = _require(op.join(_data_dir(), "visor_depth"),
                             "visor_depth dir")
        samples = []
        for k, v in bbox.items():
            fileid = k.split("/")[-1].replace("jpg", "png")
            dp = op.join(depth_dir, fileid)
            if op.exists(dp):
                samples.append({"key": k, "bbox": v, "depth_path": dp})
        return samples

    def _img_path(self, key: str) -> str:
        return key if op.isabs(key) else op.join(_data_dir(), key)

    def _to_record(self, s: dict) -> Record:
        import cv2

        img, ok = _read_image(self._img_path(s["key"]),
                              dummy_shape=(2800, 2000, 3))
        W, H = self.IMG_W, self.IMG_H
        depth = cv2.imread(s["depth_path"], cv2.IMREAD_ANYDEPTH)
        depth = (depth.astype(np.float32) / 1000.0) if depth is not None \
            else np.zeros(img.shape[:2], np.float32)
        ann = s["bbox"]

        def det_bbox(side):
            bb = ann.get(f"{side}_bbox")
            return None if bb is None else np.asarray(bb, np.float32)

        r_bbox, l_bbox = det_bbox("right"), det_bbox("left")
        right_valid = float(r_bbox is not None)
        left_valid = float(l_bbox is not None)
        return Record(
            imgname=s["key"], image=img, K=np.eye(3, dtype=np.float32),
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(W, H),
            r_bbox=r_bbox, l_bbox=l_bbox, bbox_mode=1.0,
            depth=depth,
            right_valid=right_valid, left_valid=left_valid,
            is_valid=float(ok),
            joints_valid_r=np.zeros(21, np.float32),
            joints_valid_l=np.zeros(21, np.float32),
            is_egocam=1.0, use_gt_k=0.0,
            wp_focal=_wp_focal(self.cfg, W, H),
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# ---------------------------------------------------------------------- H2O
# H2O-order -> MANO-order joint reindex (h2o_dataset.py:61)
_H2O_TO_MANO = np.asarray(
    [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3, 4, 8, 12, 16, 20]
)


class H2ODataset(RecordDataset):
    """H2O egocentric eval set (reference ``h2o_dataset.py``): frame list
    from ``h2o/local_{train,val}.txt``; per-frame ``hand_pose`` txt rows
    ``[valid, 21x3 joints]`` (left then right), MANO params from
    ``hand_pose_mano`` (``[valid, trans(3), pose(48), beta(10)]`` per hand),
    per-sequence ``cam_intrinsics.txt``; 2D joints projected from 3D."""

    name = "h2o"
    _FLAGS = default_flags(j2d=1, j3d=1, pose=1, beta=1, cam=1)

    def _load_samples(self) -> List[dict]:
        base = _require(op.join(_data_dir(), "h2o"), "H2O root")
        local_split = "local_train" if "train" in self.split else "local_val"
        split_f = _require(op.join(base, f"{local_split}.txt"),
                           "H2O split file")
        with open(split_f) as f:
            imgnames = [line.strip() for line in f if line.strip()]
        samples = []
        for file in imgnames:
            seqname = "/".join(file.split("/")[-6:-2])
            index = file.split("/")[-1].split(".")[0]
            samples.append({"seq": seqname, "idx": index, "base": base})
        return samples

    def _to_record(self, s: dict) -> Record:
        base, seq, idx = s["base"], s["seq"], s["idx"]
        img, ok = _read_image(op.join(base, seq, "rgb", f"{idx}.png"),
                              dummy_shape=(2800, 2000, 3))
        try:
            hp = np.loadtxt(op.join(base, seq, "hand_pose", f"{idx}.txt"))
            mano = np.loadtxt(
                op.join(base, seq, "hand_pose_mano", f"{idx}.txt"))
            Kv = np.loadtxt(op.join(base, seq, "cam_intrinsics.txt"))
        except Exception:
            raise DataNotFoundError(f"H2O labels for {seq}/{idx}")
        K = np.asarray([[Kv[0], 0, Kv[2]], [0, Kv[1], Kv[3]], [0, 0, 1]],
                       np.float32)
        # rows: left hand first (h2o_dataset.py:78-84)
        l_valid, l_jts = float(hp[0]), hp[1:64].reshape(21, 3)
        r_valid, r_jts = float(hp[64]), hp[65:128].reshape(21, 3)
        l_jts = l_jts[_H2O_TO_MANO].astype(np.float32)
        r_jts = r_jts[_H2O_TO_MANO].astype(np.float32)
        l_mano, r_mano = mano[:62], mano[62:]
        pose_l, beta_l = l_mano[4:52].astype(np.float32), \
            l_mano[52:62].astype(np.float32)
        pose_r, beta_r = r_mano[4:52].astype(np.float32), \
            r_mano[52:62].astype(np.float32)

        def proj(j):
            p = j @ K.T
            return du.pad_jts2d((p[:, :2] / np.maximum(p[:, 2:], 1e-9))
                                .astype(np.float32))

        H, W = img.shape[:2]
        return Record(
            imgname=f"{seq}/rgb/{idx}.png", image=img, K=K,
            j2d_r=proj(r_jts), j2d_l=proj(l_jts),
            j3d_r=r_jts, j3d_l=l_jts,
            pose_r=pose_r, pose_l=pose_l, beta_r=beta_r, beta_l=beta_l,
            bbox=_centered_bbox(W, H),
            right_valid=r_valid, left_valid=l_valid,
            is_valid=float(ok), is_egocam=1.0, use_gt_k=1.0,
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# ------------------------------------------------------------------- EgoExo
class EgoExoDataset(RecordDataset):
    """Ego-Exo4D hand annotations (reference ``ego_exo_dataset.py``:
    ``ego4d_hands/joint_annotations_egoexo_val.pkl``). Each entry carries the
    decoded crop image, named per-joint 2D/3D annotations, the full-res
    intrinsics and both sizes; j2d=j3d=1 with **per-joint** 3D validity
    (drives the masked-Procrustes eval path, eval_modules.py:231-317)."""

    name = "egoexo"
    _FLAGS = default_flags(j2d=1, j3d=1)
    # joint-name ordering (ego_exo_dataset.py:43-45)
    INDEX2JOINTS = {
        0: "wrist", 1: "index_1", 2: "index_2", 3: "index_3", 4: "middle_1",
        5: "middle_2", 6: "middle_3", 7: "pinky_1", 8: "pinky_2",
        9: "pinky_3", 10: "ring_1", 11: "ring_2", 12: "ring_3",
        13: "thumb_1", 14: "thumb_2", 15: "thumb_3", 16: "thumb_4",
        17: "index_4", 18: "middle_4", 19: "ring_4", 20: "pinky_4",
    }

    def _load_samples(self) -> List[dict]:
        p = _require(
            op.join(_data_dir(),
                    "ego4d_hands/joint_annotations_egoexo_val.pkl"),
            "EgoExo annotations",
        )
        with open(p, "rb") as f:
            data = pickle.load(f)
        return [{"key": k, "ann": v} for k, v in data.items()]

    def _to_record(self, s: dict) -> Record:
        ann = s["ann"]
        img = np.asarray(ann["img"])
        crop_h, crop_w = ann["crop_size"]
        img_w, img_h = float(ann["image_size"][0]), float(ann["image_size"][1])
        # intrx lives in full-res space; the pixels are the uniformly
        # downscaled crop -> scale K so the on-device crop-adjusted K equals
        # the reference's get_aug_intrix(image-centred max-side box) result
        K = np.asarray(ann["intrx"], np.float32).copy()
        K[:2] *= max(crop_w, crop_h) / max(img_w, img_h)

        def side_arrays(dict_key, comps):
            arrs = {"left": [], "right": []}
            valids = {"left": [], "right": []}
            data = ann.get(dict_key, {})
            for i in range(21):
                joint = self.INDEX2JOINTS[i]
                for side in ("left", "right"):
                    cur = data.get(f"{side}_{joint}")
                    if cur is not None:
                        arrs[side].append([cur[c] for c in comps])
                        valids[side].append(1.0)
                    else:
                        arrs[side].append([0.0] * len(comps))
                        valids[side].append(0.0)
            return ({k: np.asarray(v, np.float32) for k, v in arrs.items()},
                    {k: np.asarray(v, np.float32) for k, v in valids.items()})

        j3d, j3d_valid = side_arrays("j3d", ("x", "y", "z"))
        j2d, j2d_valid = side_arrays("j2d", ("x", "y"))
        val_r = float(j2d_valid["right"].sum() > 3)
        val_l = float(j2d_valid["left"].sum() > 3)
        return Record(
            imgname=s["key"], image=img, K=K,
            j2d_r=du.pad_jts2d(j2d["right"]), j2d_l=du.pad_jts2d(j2d["left"]),
            j3d_r=j3d["right"], j3d_l=j3d["left"],
            beta_r=MEAN_BETA_R, beta_l=MEAN_BETA_L,
            bbox=_centered_bbox(crop_w, crop_h),
            joints_valid_r=j2d_valid["right"] * val_r,
            joints_valid_l=j2d_valid["left"] * val_l,
            joints3d_valid_r=j3d_valid["right"] * val_r,
            joints3d_valid_l=j3d_valid["left"] * val_l,
            right_valid=val_r, left_valid=val_l, is_valid=1.0,
            is_egocam=1.0, use_gt_k=1.0,
            loss_flags=dict(self._FLAGS), dataset=self.name,
        )


# -------------------------------------------------------------- synthetic
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
        j2d_r = du.pad_jts2d(lr["j2d"][i])
        j2d_l = du.pad_jts2d(ll["j2d"][i])

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


# -------------------------------------------------------------------- concat
class ConcatDataset:
    """'a+b+c' mixed-dataset training (reference ``factory.py:37-73``)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


DATASET_REGISTRY = {
    "hands": HandsLightDataset,
    "arctic": ArcticDataset,
    "sample": SampleDataset,
    "assembly": AssemblyDataset,
    "epic": EPICDataset,
    "epic_grasp": EPICGraspDataset,
    "epic_seg": EPICSegDataset,
    "epic_depth": EPICDepthDataset,
    "ego_grasp": Ego4DGraspDataset,
    "ego_seg": Ego4DSegDataset,
    "h2o": H2ODataset,
    "egoexo": EgoExoDataset,
    "synthetic": SyntheticRecordDataset,
}


def fetch_dataset(cfg: Config, names: str, split: str):
    """Resolve 'a+b+c' into a (Concat)Dataset (reference
    ``fetch_dataset_devel``, factory.py:19)."""
    parts = names.split("+")
    built = [DATASET_REGISTRY[p](cfg, split) for p in parts]
    if len(built) == 1:
        return built[0]
    return ConcatDataset(built)
