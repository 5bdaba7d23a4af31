"""Port parity of the real datasets: ``hands_tpu_torch.data.datasets`` (the
ten families, ``a+b+c`` mixes, the image reader), ``data.dataset_utils`` and
``utils.native`` against the JAX package's, on one miniature on-disk tree
of every family in the upstream project's layouts (split npys, misc.json,
COCO jsons, pkls, txt trees, npz masks, 16-bit pngs, encoded images).

The tree builders below are module-level functions that import neither JAX
nor the JAX package (cv2 only, inside them): ``chip_smoke.py`` loads this
file by path and builds the same tree on the card. JAX is imported inside
the tests.

Also here: the assertions of ``tests/test_real_layout_fixtures.py`` on one
batch of the port's loader, ``cli.pack_records --dataset``, serving a
checkpoint (``cli.demo --ckpt``, ``cli.calibrate --ckpt``), the learning
check's plumbing and the int8 drift tool on the CPU.
"""

import copy
import dataclasses
import filecmp
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

IMG_W, IMG_H = 128, 96
ARCTIC_FULL = (400, 300)  # full-resolution ARCTIC frames (W, H)
ARCTIC_IOI = 10  # the subject's image-index offset
ARCTIC_TRAIN, ARCTIC_VAL = 8, 4  # egocentric frames of each split
N_ASSEMBLY = {"train": 8, "val": 2}
N_EPIC, N_GRASP, N_SEG, N_EGOEXO = 3, 2, 4, 3
EGOEXO_FULL = (512, 384)

# what each name gives on the tree: (split, records, loss flags set to 1)
EXPECTED = {
    "hands": ("val", ARCTIC_VAL + 1, ("j2d", "j3d", "pose", "beta", "cam")),
    "arctic": ("val", ARCTIC_VAL + 1, ("j2d", "j3d", "pose", "beta", "cam")),
    "sample": ("train", 2, ("j2d", "j3d", "pose", "beta", "cam")),
    "assembly": ("val", N_ASSEMBLY["val"], ("j2d", "j3d")),
    "epic": ("val", N_EPIC, ("j2d",)),
    # grasp_visor_train.pkl also holds the boxes of the seg and depth frames
    "epic_grasp": ("train", N_GRASP + N_SEG + 1, ("grasp",)),
    "ego_grasp": ("train", N_GRASP + N_SEG, ("grasp",)),
    "epic_seg": ("train", N_SEG, ("mask",)),
    "ego_seg": ("train", N_SEG, ("mask",)),
    "epic_depth": ("train", 1, ("depth",)),
    "h2o": ("val", 1, ("j2d", "j3d", "pose", "beta", "cam")),
    "egoexo": ("test", N_EGOEXO, ("j2d", "j3d")),
}
# the mix that phase 13 of chip_smoke.py trains on (the config's default)
TRAIN_MIX = "hands+assembly+epic_grasp+epic_seg"
TRAIN_MIX_LEN = ARCTIC_TRAIN + N_ASSEMBLY["train"] + N_GRASP + N_SEG + 1 \
    + N_SEG


def _img(seed=0, w=IMG_W, h=IMG_H):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def _write_img(path, img):
    """An RGB image as a JPEG or PNG (by the extension), through cv2."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(path, img[:, :, ::-1])


def _merge_pkl(path, entries):
    """Add ``entries`` to the dict pickled at ``path`` (several families
    share one pkl)."""
    data = {}
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = pickle.load(f)
    data.update(entries)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


# ------------------------------------------------------------------- ARCTIC
def build_arctic_tree(root, ego_scale=0.3):
    """Split npys ``p2a_{train,val}`` (data_dict keyed sid/seq, arrays
    [vidx, view]; view 0 egocentric), misc.json, full and pre-cropped
    images. The val split ends with one exocentric frame (view 2)."""
    import cv2

    base = os.path.join(root, "arctic/data/arctic_data/data")
    full_w, full_h = ARCTIC_FULL
    n_frames = max(ARCTIC_TRAIN, ARCTIC_VAL)
    rng = np.random.RandomState(0)
    K_ego = np.asarray(
        [[300.0, 0, full_w / 2], [0, 300.0, full_h / 2], [0, 0, 1]])
    n_views = 9
    j3d = rng.rand(n_frames, n_views, 21, 3) * 0.2 + [[-0.1, -0.1, 0.5]]
    j3d_l = j3d + 0.01

    def proj(j):
        p = np.einsum("fvjk,lk->fvjl", j, K_ego)
        return p[..., :2] / p[..., 2:]

    data_dict = {"s01/box_grab_01": {
        "cam_coord": {
            "joints.right": j3d.astype(np.float32),
            "joints.left": j3d_l.astype(np.float32),
            "rot_r_cam": rng.randn(n_frames, n_views, 3).astype(np.float32)
            * 0.1,
            "rot_l_cam": rng.randn(n_frames, n_views, 3).astype(np.float32)
            * 0.1,
            "is_valid": np.ones((n_frames, n_views), np.float32),
            "right_valid": np.ones((n_frames, n_views), np.float32),
            "left_valid": np.ones((n_frames, n_views), np.float32),
        },
        "2d": {"joints.right": proj(j3d).astype(np.float32),
               "joints.left": proj(j3d_l).astype(np.float32)},
        "bbox": np.tile(np.asarray(
            [full_w / 2, full_h / 2, max(full_w, full_h) / 200.0],
            np.float32), (n_frames, n_views, 1)),
        "params": {
            "pose_r": rng.randn(n_frames, 45).astype(np.float32) * 0.1,
            "pose_l": rng.randn(n_frames, 45).astype(np.float32) * 0.1,
            "shape_r": rng.randn(n_frames, 10).astype(np.float32) * 0.1,
            "shape_l": rng.randn(n_frames, 10).astype(np.float32) * 0.1,
            "K_ego": np.tile(K_ego.astype(np.float32), (n_frames, 1, 1)),
            "dist": rng.randn(n_frames, 8).astype(np.float32) * 0.01,
        },
    }}

    def name(view, f):
        return (f"./arctic_data/data/images/s01/box_grab_01/{view}/"
                f"{ARCTIC_IOI + f:05d}.jpg")

    os.makedirs(os.path.join(base, "splits"), exist_ok=True)
    for split, names in (
            ("train", [name(0, f) for f in range(ARCTIC_TRAIN)]),
            ("val", [name(0, f) for f in range(ARCTIC_VAL)] + [name(2, 0)])):
        np.save(os.path.join(base, f"splits/p2a_{split}.npy"),
                {"data_dict": data_dict, "imgnames": names},
                allow_pickle=True)
    misc = {"s01": {
        "intris_mat": [K_ego.tolist()] * 8,
        "image_size": [[full_w, full_h]] * 9,
        "ioi_offset": ARCTIC_IOI,
        "world2cam": [np.eye(4).tolist()] * 8,
    }}
    os.makedirs(os.path.join(base, "meta"), exist_ok=True)
    with open(os.path.join(base, "meta/misc.json"), "w") as f:
        json.dump(misc, f)

    full = _img(1, full_w, full_h)
    small = cv2.resize(full, None, fx=ego_scale, fy=ego_scale,
                       interpolation=cv2.INTER_AREA)
    seq = "s01/box_grab_01"
    for f in range(n_frames):
        stem = f"{ARCTIC_IOI + f:05d}.jpg"
        _write_img(os.path.join(base, f"cropped_images/{seq}/0/{stem}"),
                   small)
        _write_img(os.path.join(base, f"images/{seq}/0/{stem}"), full)
    _write_img(os.path.join(base, f"cropped_images/{seq}/2/{ARCTIC_IOI:05d}"
                                  f".jpg"), _img(3, 1000, 1000))
    return K_ego


# ------------------------------------------------------------------- sample
def build_sample_tree(root):
    """``sample_data/samples.pkl``: a list of dicts with the Record fields,
    and the images beside it."""
    rng = np.random.RandomState(12)
    samples = []
    for i in range(EXPECTED["sample"][1]):
        name = f"img_{i}.png"
        _write_img(os.path.join(root, "sample_data", name), _img(90 + i))
        samples.append({
            "imgname": name,
            "K": [[200.0, 0, IMG_W / 2], [0, 200.0, IMG_H / 2], [0, 0, 1]],
            "j2d_r": np.concatenate([rng.rand(21, 2) * [IMG_W, IMG_H],
                                     np.ones((21, 1))], 1).astype(np.float32),
            "j3d_r": (rng.rand(21, 3) * 0.1 + [0, 0, 0.5]).astype(np.float32),
            "pose_r": (rng.randn(48) * 0.1).astype(np.float32),
            "beta_r": (rng.randn(10) * 0.1).astype(np.float32),
        })
    with open(os.path.join(root, "sample_data/samples.pkl"), "wb") as f:
        pickle.dump(samples, f)


# ----------------------------------------------------------------- Assembly
ASSEMBLY_SEQ, ASSEMBLY_CAM = "nusar-2021_action_both", "HMC_21176875"
ASSEMBLY_K = np.asarray([[150.0, 0, IMG_W / 2], [0, 150.0, IMG_H / 2],
                         [0, 0, 1]])


def build_assembly_tree(root):
    """COCO-format ``assemblyhands_{mode}_ego_{data,calib}_v1-1.json`` and
    ``_joint_3d_v1-1.json`` per mode; world joints in mm, identity
    extrinsics; the first annotation has no left box and joint 0 invalid."""
    rng = np.random.RandomState(9)
    Rt = np.hstack([np.eye(3), np.zeros((3, 1))])
    for mode, n in N_ASSEMBLY.items():
        ann_dir = os.path.join(root, "assembly/annotations", mode)
        os.makedirs(ann_dir, exist_ok=True)
        images, anns, extr, joints = [], [], {}, {}
        for i in range(n):
            frame = 10 + i
            fname = f"{ASSEMBLY_SEQ}/{ASSEMBLY_CAM}/{frame:06d}.jpg"
            _write_img(os.path.join(root, "assembly/images", fname),
                       _img(70 + i))
            jv = np.ones(42)
            jv[0] = 0.0
            images.append({"id": i + 1, "seq_name": ASSEMBLY_SEQ,
                           "camera": ASSEMBLY_CAM, "frame_idx": frame,
                           "file_name": fname, "width": IMG_W,
                           "height": IMG_H})
            anns.append({"id": 11 + i, "image_id": i + 1,
                         "joint_valid": jv.tolist(),
                         "bbox": {"right": [5, 5, 60, 50],
                                  "left": None if i == 0
                                  else [50, 30, 120, 90]}})
            extr[f"{frame:06d}"] = {ASSEMBLY_CAM + "_mono10bit": Rt.tolist()}
            joints[f"{frame:06d}"] = {"world_coord": (
                rng.rand(42, 3) * 100 + [[0, 0, 400]]).tolist()}
        v = "v1-1"
        with open(os.path.join(
                ann_dir, f"assemblyhands_{mode}_ego_data_{v}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
        with open(os.path.join(
                ann_dir, f"assemblyhands_{mode}_ego_calib_{v}.json"),
                "w") as f:
            json.dump({"calibration": {ASSEMBLY_SEQ: {
                "intrinsics": {ASSEMBLY_CAM + "_mono10bit":
                               ASSEMBLY_K.tolist()},
                "extrinsics": extr}}}, f)
        with open(os.path.join(
                ann_dir, f"assemblyhands_{mode}_joint_3d_{v}.json"),
                "w") as f:
            json.dump({"annotations": {ASSEMBLY_SEQ: joints}}, f)


# --------------------------------------------------------------------- EPIC
def build_epic_tree(root):
    """``epic_hands/hands_{250,5000}.pkl`` (frame 0 without a left hand; 5
    of the right hand's joints invalid) and the detected boxes of the test
    split, ``grasp_visor_val.pkl``."""
    base = os.path.join(root, "epic_hands")
    rng = np.random.RandomState(2)
    ann = {}
    for i in range(N_EPIC):
        key = f"epic_frames/frame_{i}.jpg"
        _write_img(os.path.join(root, key), _img(10 + i))
        jv = np.ones(21)
        jv[:5] = 0.0
        entry = {"right": {"bbox": None,
                           "joints": list(rng.rand(21, 2) * [IMG_W, IMG_H]),
                           "joints_valid": list(jv)}}
        if i > 0:
            entry["left"] = {"bbox": None,
                             "joints": list(rng.rand(21, 2) * [IMG_W, IMG_H]),
                             "joints_valid": list(np.ones(21))}
        ann[key] = entry
    for name in ("hands_250.pkl", "hands_5000.pkl"):
        _merge_pkl(os.path.join(base, name), ann)
    _merge_pkl(os.path.join(base, "grasp_visor_val.pkl"), {
        k: {"right_bbox": [10.0, 10.0, 60.0, 50.0], "left_bbox": None}
        for k in ann})
    return ann


# ---------------------------------------------------------- grasp, seg, depth
GRASPS = [("Pow-Pris", None), (None, "Later")]


def build_grasp_tree(root, subdir, pklname):
    ann = {}
    for i, (rg, lg) in enumerate(GRASPS):
        key = f"grasp_frames/frame_{i}.jpg"
        _write_img(os.path.join(root, key), _img(20 + i))
        ann[key] = {"right_grasp": rg, "left_grasp": lg,
                    "right_bbox": [8.0, 8.0, 70.0, 60.0] if rg else None,
                    "left_bbox": [30.0, 20.0, 90.0, 80.0] if lg else None}
    _merge_pkl(os.path.join(root, subdir, pklname), ann)
    return ann


def build_seg_tree(root, subdir, masks_name, boxes_name):
    """Value-coded masks (R 255, L 127) in an npz, modal/amodal labels
    (frame i: right modal, left modal iff i is odd) and detected boxes
    beside the grasp labels."""
    base = os.path.join(root, subdir)
    masks, modal, boxes = {}, {}, {}
    for i in range(N_SEG):
        key = f"seg_frames/{subdir}_{i}.jpg"
        _write_img(os.path.join(root, key), _img(30 + i))
        mask = np.zeros((IMG_H, IMG_W), np.uint8)
        mask[10:40, 20:60] = 255
        mask[50:80, 70:110] = 127
        masks[key] = np.stack([mask] * 3, -1)
        modal[key] = {"right": 1, "left": i % 2}
        boxes[key] = {"right_bbox": [15.0, 5.0, 65.0, 45.0],
                      "left_bbox": [65.0, 45.0, 115.0, 85.0],
                      "right_grasp": None, "left_grasp": None}
    os.makedirs(base, exist_ok=True)
    np.savez(os.path.join(base, masks_name), **masks)
    _merge_pkl(os.path.join(base, "modal_amodal_annot.pkl"), modal)
    _merge_pkl(os.path.join(base, boxes_name), boxes)


def build_depth_tree(root):
    """A 16-bit png of 1500 mm in ``visor_depth/`` and its boxes."""
    import cv2

    key = "depth_frames/frame_7.jpg"
    _write_img(os.path.join(root, key), _img(40))
    os.makedirs(os.path.join(root, "visor_depth"), exist_ok=True)
    depth_mm = (np.ones((IMG_H, IMG_W)) * 1500).astype(np.uint16)
    assert cv2.imwrite(os.path.join(root, "visor_depth/frame_7.png"),
                       depth_mm)
    _merge_pkl(os.path.join(root, "epic_hands/grasp_visor_train.pkl"), {
        key: {"right_bbox": [10.0, 10.0, 60.0, 50.0], "left_bbox": None,
              "right_grasp": None, "left_grasp": None}})


# ---------------------------------------------------------------------- H2O
H2O_SEQ = "subject1/h1/0/cam4"
H2O_F = (120.0, 121.0, IMG_W / 2, IMG_H / 2)


def build_h2o_tree(root):
    """One frame: png, ``hand_pose`` rows (left first), ``hand_pose_mano``,
    ``cam_intrinsics.txt``, and the split lists."""
    seq_dir = os.path.join(root, "h2o", H2O_SEQ)
    for sub in ("rgb", "hand_pose", "hand_pose_mano"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    _write_img(os.path.join(seq_dir, "rgb/000000.png"), _img(50))
    np.savetxt(os.path.join(seq_dir, "cam_intrinsics.txt"),
               list(H2O_F) + [IMG_W, IMG_H])
    rng = np.random.RandomState(5)
    jl = rng.rand(21, 3) * 0.1 + [0, 0, 0.4]
    jr = rng.rand(21, 3) * 0.1 + [0, 0, 0.4]
    np.savetxt(os.path.join(seq_dir, "hand_pose/000000.txt"),
               np.concatenate([[1.0], jl.ravel(), [1.0], jr.ravel()]))
    mano = np.concatenate([
        [1.0], rng.randn(3), rng.randn(48) * 0.1, rng.randn(10) * 0.1,
        [1.0], rng.randn(3), rng.randn(48) * 0.1, rng.randn(10) * 0.1])
    np.savetxt(os.path.join(seq_dir, "hand_pose_mano/000000.txt"), mano)
    for split in ("local_train", "local_val"):
        with open(os.path.join(root, f"h2o/{split}.txt"), "w") as f:
            f.write(f"{root}/h2o/{H2O_SEQ}/rgb/000000.png\n")
    return jl, jr, mano


# ------------------------------------------------------------------- EgoExo
EGOEXO_JOINTS = (["wrist"] + [f"{f}_{i}" for f in
                              ("index", "middle", "pinky", "ring")
                              for i in (1, 2, 3)]
                 + [f"thumb_{i}" for i in (1, 2, 3, 4)]
                 + ["index_4", "middle_4", "ring_4", "pinky_4"])
EGOEXO_K = np.asarray([[400.0, 0, EGOEXO_FULL[0] / 2],
                       [0, 400.0, EGOEXO_FULL[1] / 2], [0, 0, 1]])


def build_egoexo_tree(root):
    """``joint_annotations_egoexo_val.pkl``: decoded crops and named
    per-joint 2D/3D annotations; the right hand misses ``middle_2`` (MANO
    index 5), the first frame has no left hand."""
    rng = np.random.RandomState(11)
    ann = {}
    for fi in range(N_EGOEXO):
        j3d, j2d = {}, {}
        for side in ("right", "left"):
            if side == "left" and fi == 0:
                continue
            for name in EGOEXO_JOINTS:
                if side == "right" and name == "middle_2":
                    continue
                p = rng.rand(3) * 0.1 + [0, 0, 0.5]
                j3d[f"{side}_{name}"] = {"x": p[0], "y": p[1], "z": p[2]}
                q = EGOEXO_K @ p
                j2d[f"{side}_{name}"] = {"x": q[0] / q[2], "y": q[1] / q[2]}
        ann[f"frame_{fi}"] = {
            "img": _img(80 + fi), "crop_size": (IMG_H, IMG_W),
            "image_size": EGOEXO_FULL, "intrx": EGOEXO_K,
            "j3d": j3d, "j2d": j2d}
    _merge_pkl(os.path.join(root,
                            "ego4d_hands/joint_annotations_egoexo_val.pkl"),
               ann)


def build_tree(root):
    """Every family's miniature tree under ``root`` (the ``$DATA_DIR``)."""
    build_arctic_tree(root)
    build_sample_tree(root)
    build_assembly_tree(root)
    build_epic_tree(root)
    build_grasp_tree(root, "epic_hands", "grasp_visor_train.pkl")
    build_grasp_tree(root, "ego4d_hands", "grasp_ego.pkl")
    build_seg_tree(root, "epic_hands", "visor_pred_masks_train.npz",
                   "grasp_visor_train.pkl")
    build_seg_tree(root, "ego4d_hands", "ego_blur_pred_masks.npz",
                   "grasp_ego.pkl")
    build_depth_tree(root)
    build_h2o_tree(root)
    build_egoexo_tree(root)


def check_records(ds, name):
    """The record count, loss flags, dataset name and decoded images
    (``ok``) that ``EXPECTED`` gives for ``name``; returns the records."""
    from hands_tpu_torch.data.records import LOSS_FLAGS

    split, n, on = EXPECTED[name]
    assert len(ds) == n, (name, len(ds), n)
    recs = [ds[i] for i in range(len(ds))]
    flags = {f"is_{k}_loss" for k in on}
    for r in recs:
        assert r.dataset == name, (name, r.dataset)
        assert {k for k in LOSS_FLAGS if r.loss_flags[k] == 1.0} == flags, \
            (name, r.loss_flags)
        assert r.is_valid == 1.0 and r.image.dtype == np.uint8, name
        assert r.image.max() > 0, (name, r.imgname)  # a decoded image
    return recs


# ------------------------------------------------------------------- tests
@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    build_tree(root)
    return root


@pytest.fixture
def data_dir(tree, monkeypatch):
    monkeypatch.setenv("DATA_DIR", tree)
    return tree


def _cfg(**kw):
    from hands_tpu_torch.config import default_config

    return default_config("hands_light", **kw)


def _jax_cfg(**kw):
    from hands_tpu.config import default_config

    return default_config("hands_light", **kw)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return type(a) is type(b) and a == b


def assert_records_equal(got, want, what=""):
    """Field by field: arrays with their dtypes, scalars with their types,
    ``loss_flags`` and ``dataset``."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert _equal(a, b), (what, f.name, a, b)


@pytest.mark.parametrize("name", sorted(EXPECTED) + [TRAIN_MIX])
def test_records_equal_the_jax_records(data_dir, name):
    """Each registry name (and the default training mix) resolves in both
    packages on one tree, and every record is equal field by field."""
    from hands_tpu.data import datasets as JD
    from hands_tpu_torch.data import datasets as TD

    split = "train" if name == TRAIN_MIX else EXPECTED[name][0]
    jds = JD.fetch_dataset(_jax_cfg(), name, split)
    tds = TD.fetch_dataset(_cfg(), name, split)
    assert type(tds).__name__ == type(jds).__name__
    assert len(tds) == len(jds) > 0
    if name == TRAIN_MIX:
        assert isinstance(tds, TD.ConcatDataset) and len(tds) == TRAIN_MIX_LEN
        assert [len(d) for d in tds.datasets] == \
            [len(d) for d in jds.datasets]
    else:
        check_records(tds, name)
    for i in range(len(jds)):
        assert_records_equal(tds[i], jds[i], f"{name}[{i}]")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_missing_tree_raises_data_not_found(name, tmp_path, monkeypatch):
    from hands_tpu_torch.data import datasets as TD

    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    with pytest.raises(TD.DataNotFoundError, match=str(tmp_path)):
        TD.fetch_dataset(_cfg(), name, EXPECTED[name][0])


def test_downsample_on_the_real_layouts(data_dir):
    """mini/tiny splits subsample the pkls and split npys the reference's
    way: the same records, in the same order, as the JAX package."""
    from hands_tpu.data import datasets as JD
    from hands_tpu_torch.data import dataset_utils as du
    from hands_tpu_torch.data import datasets as TD

    full = TD.EPICDataset(_cfg(), "val")
    mini = TD.EPICDataset(_cfg(), "minival")
    assert len(mini) == min(80, len(full)) == N_EPIC
    arctic = TD.HandsLightDataset(_cfg(), "minival")  # reads p2a_val.npy
    assert len(arctic) == ARCTIC_VAL + 1
    for cls in ("EPICDataset", "HandsLightDataset", "AssemblyDataset"):
        for split in ("minival", "tinyval"):
            t = getattr(TD, cls)(_cfg(), split)
            j = getattr(JD, cls)(_jax_cfg(), split)
            assert [r.imgname for r in t] == [r.imgname for r in j]
    assert du.downsample(list(range(100)), "minitrain") == \
        du.downsample(list(range(100)), "minitrain")
    assert du.get_num_images("smallval", 20000) == 12000


def _tree_images(tree):
    return sorted(glob.glob(os.path.join(tree, "**/*.jpg"), recursive=True)
                  + glob.glob(os.path.join(tree, "**/*.png"), recursive=True))


@pytest.mark.parametrize("scale_denom", [1, 2])
def test_native_decode_equals_the_jax_native_decode_and_cv2(tree,
                                                            scale_denom):
    """Every JPEG and PNG of the tree (the 16-bit depth png aside): the
    port's native decode is bit-equal to the JAX package's and to cv2's
    (at ``scale_denom`` 2 to cv2's scaled JPEG decode)."""
    import cv2

    from hands_tpu.utils import native as jn
    from hands_tpu_torch.data import datasets as TD
    from hands_tpu_torch.utils import native

    assert native.available() and jn.available()
    reduced = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2}
    paths = [p for p in _tree_images(tree) if "visor_depth" not in p]
    assert len(paths) > 30
    for p in paths:
        got = native.read_image(p, scale_denom)
        data = open(p, "rb").read()
        assert np.array_equal(got, jn.decode_image(data, scale_denom)), p
        if p.endswith(".jpg") or scale_denom == 1:  # native: PNGs at 1
            want = cv2.imread(p, reduced[scale_denom])[:, :, ::-1]
            assert np.array_equal(got, want), p
            # the reader's cv2 route gives the native route's pixels
            assert np.array_equal(TD._cv2_read(p, scale_denom), got), p
    assert native.read_image(os.path.join(tree, "no_such.jpg")) is None


def test_native_warps_and_stack_equal_the_jax_ones(tree):
    """``warp_affine``, ``warp_affine_normalize`` and ``stack_images`` of
    the port's build against the JAX package's, bit for bit."""
    from hands_tpu.utils import native as jn
    from hands_tpu_torch.utils import native

    imgs = [native.read_image(os.path.join(tree, f"epic_frames/frame_{i}"
                                                 ".jpg")) for i in range(2)]
    M = np.asarray([[0.9, 0.1, 3.5], [-0.2, 1.1, -4.25]], np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    assert np.array_equal(native.warp_affine(imgs[0], M, (40, 50)),
                          jn.warp_affine(imgs[0], M, (40, 50)))
    assert np.array_equal(
        native.warp_affine_normalize(imgs[0], M, (40, 50), mean, std),
        jn.warp_affine_normalize(imgs[0], M, (40, 50), mean, std))
    got = native.stack_images(imgs)
    assert got.shape == (2, IMG_H, IMG_W, 3)
    assert np.array_equal(got, jn.stack_images(imgs))


def test_reader_routes_and_the_dummy_image(tree, monkeypatch):
    """``_read_image`` takes the native route where it builds and cv2
    otherwise, with the same pixels; a file that cannot be read gives the
    zero image of ``dummy_shape`` and ``ok=False``."""
    from hands_tpu_torch.data import datasets as TD
    from hands_tpu_torch.utils import native

    p = os.path.join(tree, "epic_frames/frame_0.jpg")
    assert TD.image_decoder() == "native"
    a, ok = TD._read_image(p, scale_denom=2)
    monkeypatch.setattr(native, "available", lambda: False)
    assert TD.image_decoder() == "cv2"
    b, ok_b = TD._read_image(p, scale_denom=2)
    assert ok and ok_b and np.array_equal(a, b) and a.shape == (48, 64, 3)
    img, ok = TD._read_image(os.path.join(tree, "missing.jpg"),
                             dummy_shape=(10, 11, 3), scale_denom=2)
    assert not ok and img.shape == (5, 6, 3) and not img.any()


def _one_batch(ds, cfg, bs=2, is_train=False):
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader

    dl = DeviceDataLoader(ds, cfg, bs, is_train=is_train, seed=0,
                          drop_last=False, device="cpu", num_workers=0)
    return next(iter(dl))


LIGHT = dict(use_render_seg_loss=False, use_grasp_loss=False)


def test_arctic_speedup_and_the_loader(data_dir):
    from hands_tpu_torch.data import datasets as TD

    cfg = _cfg(**LIGHT)
    assert cfg.speedup and cfg.ego_image_scale == 0.3
    ds = TD.HandsLightDataset(cfg, "val")
    rec = ds[0]
    s = cfg.ego_image_scale
    full_w, full_h = ARCTIC_FULL
    K_ego = np.asarray(
        [[300.0, 0, full_w / 2], [0, 300.0, full_h / 2], [0, 0, 1]])
    assert rec.is_egocam == 1.0 and rec.use_gt_k == 1.0
    np.testing.assert_allclose(rec.K[0, 0], K_ego[0, 0] * s, rtol=1e-6)
    assert rec.image.shape[0] == round(full_h * s)
    assert np.isfinite(rec.dist).all() and rec.pose_r.shape == (48,)

    inputs, targets, meta = _one_batch(ds, cfg)
    dim = max(full_w, full_h) * s  # sc = 1 for the egocentric view
    k_scale = cfg.img_res / dim
    K_dev = meta["intrinsics"].numpy()[0]
    np.testing.assert_allclose(K_dev[0, 0], K_ego[0, 0] * s * k_scale,
                               rtol=1e-5)
    np.testing.assert_allclose(
        K_dev[0, 2], (K_ego[0, 2] * s - (full_w * s / 2 - dim / 2)) * k_scale,
        rtol=1e-5)
    j2 = targets["mano.j2d.norm.r"].numpy()
    assert (np.abs(j2[..., :2]) <= 1.0 + 1e-5).mean() > 0.9
    assert meta["dist"].shape == (2, 8) and np.isfinite(meta["dist"]).all()

    full = TD.HandsLightDataset(cfg.replace(speedup=False), "val")[0]
    assert full.image.shape[:2] == (full_h, full_w)
    np.testing.assert_allclose(full.K, K_ego, rtol=1e-6)


def test_arctic_exo_view(data_dir):
    """The exocentric frame: K from ``intris_mat[view - 1]``, no egocentric
    overrides, NaN distortion, labels in the 1000 px crop frame."""
    from hands_tpu_torch.data import dataset_utils as du
    from hands_tpu_torch.data import datasets as TD

    ds = TD.HandsLightDataset(_cfg(**LIGHT), "val")
    rec = ds[len(ds) - 1]
    assert rec.is_egocam == 0.0 and rec.use_gt_k is None
    assert np.isnan(rec.dist).all()
    np.testing.assert_allclose(rec.bbox, [500.0, 500.0, 1000.0 / 300.0])
    raw = ds.data_dict["s01/box_grab_01"]["2d"]["joints.right"][0, 2]
    full_w, full_h = ARCTIC_FULL
    expect = du.transform_kp2d_to_crop(
        du.pad_jts2d(raw),
        np.asarray([full_w / 2, full_h / 2, max(full_w, full_h) / 200.0]))
    np.testing.assert_allclose(rec.j2d_r[:, :2], expect[:, :2], rtol=1e-5)


def test_epic_and_its_detected_boxes(data_dir):
    from hands_tpu_torch.data import datasets as TD

    cfg = _cfg(**LIGHT)
    ds = TD.EPICDataset(cfg, "val")
    rec, key = ds[0], ds.samples[0]["key"]
    with open(os.path.join(data_dir, "epic_hands/hands_250.pkl"), "rb") as f:
        raw = np.asarray(pickle.load(f)[key]["right"]["joints"], np.float32)
    np.testing.assert_allclose(rec.j2d_r[:, :2], raw[TD._ASSEMBLY_TO_MANO],
                               rtol=1e-6)
    assert rec.right_valid == 1.0  # 16 valid joints > 3
    assert rec.use_gt_k == 0.0 and rec.is_egocam == 1.0
    np.testing.assert_allclose(
        rec.wp_focal, cfg.focal_length * cfg.img_res / 1920.0, rtol=1e-6)
    assert (rec.beta_r == TD.MEAN_BETA_R).all()
    _, _, meta = _one_batch(ds, cfg)
    K = meta["intrinsics"].numpy()[0]
    np.testing.assert_allclose(K[0, 0], rec.wp_focal, rtol=1e-5)
    np.testing.assert_allclose(K[0, 2], cfg.img_res // 2, rtol=1e-5)
    val_j2d = rec.j2d_r[:, :2]

    cfg = cfg.replace(use_gt_bbox=False)
    ds = TD.EPICDataset(cfg, "test")
    rec = ds[0]
    assert rec.bbox_mode == 1.0 and rec.l_bbox is None
    np.testing.assert_allclose(rec.r_bbox, [10, 10, 60, 50])
    inputs, _, _ = _one_batch(ds, cfg)
    res = cfg.img_res
    np.testing.assert_allclose(inputs["l_bbox"].numpy()[0],
                               [0, 0, res - 1, res - 1])
    np.testing.assert_allclose(inputs["l_bbox_og"].numpy()[0],
                               [0, 0, res - 1, res - 1])
    r_box = inputs["r_bbox"].numpy()[0]
    assert r_box[2] - r_box[0] < res - 1
    assert TD.EPICDataset(cfg.replace(use_gt_bbox=True), "test")[0] \
        .bbox_mode == 0.0
    # the scaled decode: half the pixels, labels / 2
    half = TD.EPICDataset(cfg.replace(decode_downscale=2), "val")[0]
    assert half.image.shape == (IMG_H // 2, IMG_W // 2, 3)
    np.testing.assert_allclose(half.j2d_r[:, :2], val_j2d / 2, rtol=1e-6)


def test_grasp_labels(data_dir):
    from hands_tpu_torch.data import datasets as TD

    cfg = _cfg(use_render_seg_loss=False)
    ds = TD.EPICGraspDataset(cfg, "train")
    recs = {r.imgname: r for r in ds}
    r0 = recs["grasp_frames/frame_0.jpg"]
    assert r0.grasp_r == 2 and r0.grasp_l == 8  # Pow-Pris / no grasp
    assert r0.grasp_valid_r == 1.0 and r0.grasp_valid_l == 0.0
    assert r0.bbox_mode == 1.0
    r1 = recs["grasp_frames/frame_1.jpg"]
    assert r1.grasp_l == 6 and r1.grasp_r == 8  # Later
    _, targets, _ = _one_batch(ds, cfg, is_train=True)
    assert "grasp.r" in targets
    ego = TD.Ego4DGraspDataset(cfg, "train")[0]  # the frame's own size
    np.testing.assert_allclose(
        ego.wp_focal, cfg.focal_length * cfg.img_res / IMG_W, rtol=1e-6)


def test_seg_masks_clipped_to_their_boxes(data_dir):
    from hands_tpu_torch.data import datasets as TD

    cfg = _cfg(use_grasp_loss=False)
    ds = TD.EPICSegDataset(cfg, "train")
    recs = list(ds)
    assert [r.mask_valid_r for r in recs] == [1.0] * N_SEG
    assert [r.mask_valid_l for r in recs] == [float(i % 2)
                                              for i in range(N_SEG)]
    ys, xs = np.where(recs[0].mask == 255)
    assert len(xs) and xs.min() >= 15 and xs.max() < 65 and ys.max() < 45
    _, targets, _ = _one_batch(ds, cfg, is_train=True)
    assert float(targets["render.r"].sum()) > 0


def test_seg_masks_read_from_fetch_threads(data_dir):
    """The loader's fetch threads share one npz: records read from eight
    threads at once equal those read in turn."""
    from concurrent.futures import ThreadPoolExecutor

    from hands_tpu_torch.data import datasets as TD

    ds = TD.EPICSegDataset(_cfg(use_grasp_loss=False), "train")
    want = [ds[i].mask for i in range(len(ds))]
    idx = [i % len(ds) for i in range(400)]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda i: ds[i].mask, idx))
    for i, m in zip(idx, got):
        assert np.array_equal(m, want[i])


def test_depth_from_16_bit_pngs(data_dir):
    from hands_tpu_torch.data import datasets as TD

    cfg = _cfg(use_grasp_loss=False, use_render_seg_loss=False,
               use_depth_loss=True)
    ds = TD.EPICDepthDataset(cfg, "train")
    rec = ds[0]
    np.testing.assert_allclose(rec.depth, 1.5)  # mm -> m
    assert rec.right_valid == 1.0 and rec.left_valid == 0.0
    _, targets, _ = _one_batch(ds, cfg, bs=1, is_train=True)
    d_r, d_l = targets["depth.r"].numpy()[0], targets["depth.l"].numpy()[0]
    assert 0 < (d_r > 0).mean() < 1.0
    assert (d_l > 0).mean() > (d_r > 0).mean()


def test_h2o_rows_and_joint_order(data_dir):
    from hands_tpu_torch.data import datasets as TD

    seq_dir = os.path.join(data_dir, "h2o", H2O_SEQ)
    hp = np.loadtxt(os.path.join(seq_dir, "hand_pose/000000.txt"))
    mano = np.loadtxt(os.path.join(seq_dir, "hand_pose_mano/000000.txt"))
    jl, jr = hp[1:64].reshape(21, 3), hp[65:128].reshape(21, 3)
    cfg = _cfg(**LIGHT)
    rec = TD.H2ODataset(cfg, "val")[0]
    np.testing.assert_allclose(rec.j3d_l, jl[TD._H2O_TO_MANO], rtol=1e-5)
    np.testing.assert_allclose(rec.j3d_r, jr[TD._H2O_TO_MANO], rtol=1e-5)
    np.testing.assert_allclose(rec.pose_r, mano[62 + 4:62 + 52], atol=1e-6)
    np.testing.assert_allclose(rec.K[0, 0], H2O_F[0])
    assert rec.use_gt_k == 1.0 and rec.is_egocam == 1.0
    _, targets, _ = _one_batch(TD.H2ODataset(cfg, "val"), cfg, bs=1)
    assert torch.isfinite(targets["mano.j2d.norm.r"]).all()


def test_assembly_reindex_and_camera(data_dir):
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data import datasets as TD

    cfg = default_config("hamer_light", **LIGHT)
    ds = TD.AssemblyDataset(cfg, "val")
    rec = ds[0]
    with open(os.path.join(
            data_dir, "assembly/annotations/val/"
            "assemblyhands_val_joint_3d_v1-1.json")) as f:
        jw = np.asarray(json.load(f)["annotations"][ASSEMBLY_SEQ]["000010"]
                        ["world_coord"])
    np.testing.assert_allclose(
        rec.j3d_r, jw[TD.AssemblyDataset.JOINT_TYPE_R] / 1000.0, rtol=1e-5)
    np.testing.assert_allclose(
        rec.j3d_l, jw[TD.AssemblyDataset.JOINT_TYPE_L] / 1000.0, rtol=1e-5)
    assert rec.joints_valid_r[16] == 0.0  # assembly joint 0, MANO 16
    assert rec.right_valid == 1.0 and rec.left_valid == 0.0
    assert rec.use_gt_k == 1.0 and (rec.beta_r == TD.MEAN_BETA_R).all()
    _, _, meta = _one_batch(ds, cfg)
    np.testing.assert_allclose(meta["intrinsics"].numpy()[0, 0, 0],
                               ASSEMBLY_K[0, 0] * cfg.img_res / IMG_W,
                               rtol=1e-5)


def test_egoexo_eval_epoch_uses_masked_procrustes(data_dir):
    """An evaluation epoch of the tiny WildHands model over EgoExo: the
    per-joint 3D validity reaches the targets and drives the masked
    Procrustes, and the invalid joint leaves the metrics finite."""
    from hands_tpu_torch.data import datasets as TD
    from hands_tpu_torch.data.factory import fetch_dataloader
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    rec = TD.EgoExoDataset(_cfg(), "test")[0]
    assert rec.joints3d_valid_r[5] == 0.0 and rec.joints3d_valid_r.sum() == 20
    assert rec.left_valid == 0.0 and rec.right_valid == 1.0
    np.testing.assert_allclose(
        rec.K[0, 0], EGOEXO_K[0, 0] * IMG_W / EGOEXO_FULL[0], rtol=1e-6)

    cfg = _cfg(backbone="resnet18", compute_dtype="float32",
               use_glb_feat=False, img_res=160, img_res_ds=160,
               val_dataset="egoexo", valsplit="minival", test_batch_size=2,
               num_workers=0, exp_key="egoexo", mute=True, no_vis=True,
               logger="none", **LIGHT)
    loader = fetch_dataloader(cfg, "val", device="cpu")
    _, targets, _ = next(iter(loader))
    v = targets["joints3d_valid_r"].numpy()
    assert (v[:, 5] == 0.0).all() and (v.sum(1) == 20.0).all()
    model = fetch_model(cfg, "cpu")
    exp = Experiment(cfg, root=os.path.join(data_dir, "..", "egoexo_logs"))
    metrics = Trainer(cfg, model, exp).validate(
        create_train_state(cfg, model), loader)
    exp.close()
    pa = [k for k in metrics if "mpjpe/pa" in k or "mpjpe.pa" in k]
    assert pa and all(np.isfinite(metrics[k]) for k in pa), metrics


def test_a_mixed_batch_pads_images_and_fills_masks(data_dir):
    """A batch of the training mix holds images of several sizes and masks
    on some records only: the images are zero-padded to the largest, a
    record without a mask gets zeros, and the batch preprocesses."""
    from hands_tpu_torch.data import datasets as TD
    from hands_tpu_torch.data.device_pipeline import stack_records

    ds = TD.fetch_dataset(_cfg(), "hands+epic_seg", "train")
    recs = [ds[0], ds[len(ds) - 1]]  # ARCTIC 90 x 120, then a masked 96 x 128
    assert recs[0].image.shape != recs[1].image.shape
    assert recs[0].mask is None and recs[1].mask is not None
    st = stack_records(recs)
    assert st["image"].shape == (2, IMG_H, IMG_W, 3)
    h, w = recs[0].image.shape[:2]
    assert np.array_equal(st["image"][0, :h, :w], recs[0].image)
    assert not st["image"][0, h:].any() and not st["image"][0, :, w:].any()
    assert st["mask"].shape == (2, IMG_H, IMG_W) and not st["mask"][0].any()
    assert np.array_equal(st["mask"][1], recs[1].mask.astype(np.uint8))
    # the same records alone stack as before
    alone = stack_records(recs[1:])
    assert np.array_equal(alone["mask"][0], st["mask"][1])
    inputs, targets, _ = _one_batch(ds, _cfg(use_grasp_loss=False), bs=3,
                                    is_train=True)
    assert inputs["img"].shape[0] == 3
    assert torch.isfinite(targets["render.r"]).all()


def test_pack_records_epic_equals_the_jax_pack(data_dir, tmp_path, capsys):
    """``cli.pack_records --dataset epic`` writes the set that the JAX
    ``cli/pack_records.py`` writes from the same tree, byte for byte."""
    from hands_tpu.cli import pack_records as jax_pack
    from hands_tpu_torch.cli import pack_records

    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    argv = ["--dataset", "epic", "--split", "val", "--chunk", "2"]
    assert pack_records.main(argv + ["--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n"] == N_EPIC
    assert jax_pack.main(argv + ["--out", jout]) == 0
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files and "meta.json" in files
    _, mismatch, errors = filecmp.cmpfiles(out, jout, files, shallow=False)
    assert mismatch == errors == []


TINY = dict(backbone="resnet18", compute_dtype="float32", use_glb_feat=False,
            use_render_seg_loss=False, use_grasp_loss=False, img_res=160,
            img_res_ds=160, logger="none", no_vis=True)


def _pred_files(out_dir):
    return {os.path.basename(p): dict(np.load(p))
            for p in sorted(glob.glob(os.path.join(out_dir, "*_pred.npz")))}


def test_demo_serves_the_checkpoint_that_cli_train_wrote(data_dir, tmp_path):
    """One ``cli.train`` step of the tiny WildHands model on the EPIC tree
    writes ``last``; ``cli.demo --ckpt`` then gives predictions bit-equal
    to ``restore_params`` + ``serve`` of the same images, and different
    from random weights. A checkpoint of another method raises."""
    from hands_tpu_torch.cli import calibrate as cli_calibrate
    from hands_tpu_torch.cli import demo as cli_demo
    from hands_tpu_torch.cli import train as cli_train
    from hands_tpu_torch.data.datasets import _read_image
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.checkpoint import CheckpointManager

    root = str(tmp_path / "logs")
    cli_train.main(["--dataset", "epic_grasp", "--eval_on", "epic",
                    "--batch_size", "2", "--test_batch_size", "2",
                    "--num_epoch", "1", "--num_workers", "0", "--mute",
                    "--device", "cpu", "--exp_key", "demo"],
                   log_root=root,
                   overrides=dict(TINY, use_grasp_loss=True))
    ckpt = os.path.join(root, "demo", "checkpoints", "last")
    assert os.path.isfile(ckpt)
    try:
        images = os.path.join(data_dir, "epic_frames")
        over = {k: TINY[k] for k in ("backbone", "use_glb_feat", "img_res",
                                     "img_res_ds")}
        argv = ["--dir", images, "--device", "cpu", "--batch_size", "2"]
        assert cli_demo.main(argv + ["--ckpt", ckpt, "--out",
                                     str(tmp_path / "c")], over) == 0
        assert cli_demo.main(argv + ["--out", str(tmp_path / "r")], over) == 0
        got, rnd = _pred_files(tmp_path / "c"), _pred_files(tmp_path / "r")
        assert len(got) == N_EPIC and got.keys() == rnd.keys()

        cfg = cli_demo.serving_config("hands_light").replace(**over)
        model = fetch_model(cfg, "cpu")
        left = CheckpointManager(os.path.dirname(ckpt)).restore_params(
            model, "last")
        assert left == []
        paths = sorted(glob.glob(os.path.join(images, "*.jpg")))
        recs = [cli_demo.make_record(p, _read_image(p)[0]) for p in paths]
        recs.append(copy.copy(recs[-1]))  # the demo pads its last chunk
        recs[-1].right_valid = recs[-1].left_valid = 0.0
        want = {}
        for s in range(0, len(paths), 2):
            out = cli_demo.serve(recs[s:s + 2], cfg, model, "cpu").to_np()
            for i, p in enumerate(paths[s:s + 2]):
                stem = os.path.splitext(os.path.basename(p))[0]
                want[f"{stem}_pred.npz"] = {k: out[k][i] for k in got[
                    f"{stem}_pred.npz"]}
        for f, preds in got.items():
            for k, v in preds.items():
                assert np.array_equal(v, want[f][k]), (f, k)
            assert not np.array_equal(preds["pred.mano.pose.r"],
                                      rnd[f]["pred.mano.pose.r"]), f

        # another method or width raises, never serves init weights
        with pytest.raises(ValueError, match="does not fit"):
            cli_demo.main(argv + ["--ckpt", ckpt, "--method", "hamer_light",
                                  "--out", str(tmp_path / "h")])
        with pytest.raises(ValueError, match="does not fit"):
            cli_demo.main(argv + ["--ckpt", ckpt, "--out", str(tmp_path / "w")],
                          dict(over, backbone="resnet50"))
        with pytest.raises(ValueError, match="does not fit"):
            cli_calibrate.main(["--method", "hamer_light", "--vit_variant",
                                "tiny", "--device", "cpu", "--batches", "1",
                                "--batch_size", "2", "--ckpt", ckpt, "-o",
                                str(tmp_path / "s.npz")])
        with pytest.raises(FileNotFoundError):
            cli_demo.main(argv + ["--ckpt", ckpt + "_none"], over)
    finally:
        os.remove(ckpt)


def test_calibrate_reads_a_hamer_checkpoint(tmp_path):
    """``cli.calibrate --ckpt`` calibrates the checkpoint's weights: the
    scales equal ``calibrate_scales`` on its state dict, and differ from
    those of the random weights."""
    from hands_tpu_torch.cli import calibrate as cal
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.checkpoint import CheckpointManager
    from hands_tpu_torch.train.state import create_train_state

    cfg = cal.serving_config("hamer_light")
    model = fetch_model(cfg, "cpu", seed=5, vit_variant="tiny",
                        param_dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save_last(create_train_state(cfg, model), epoch=0)
    argv = ["--method", "hamer_light", "--vit_variant", "tiny", "--device",
            "cpu", "--batches", "1", "--batch_size", "2"]
    assert cal.main(argv + ["--ckpt", os.path.join(mgr.ckpt_dir, "last"),
                            "-o", str(tmp_path / "c.npz")]) == 0
    assert cal.main(argv + ["-o", str(tmp_path / "r.npz")]) == 0
    got = cal.load_scales_npz(str(tmp_path / "c.npz"))
    rnd = cal.load_scales_npz(str(tmp_path / "r.npz"))
    want = cal.calibrate_scales(
        "hamer_light", model.state_dict(),
        cal.synthetic_batches(cfg, 2, 1, device="cpu"), vit_variant="tiny",
        device="cpu")
    for k in got:
        assert torch.equal(got[k], want[k].cpu()), k
        assert not torch.equal(got[k], rnd[k]), k


def test_numerics_check_plumbing(capsys):
    """Two steps on the CPU: the tool runs the learning leg end to end,
    prints its line, and reports that two steps do not drop the loss 10x
    (exit code 1); the bar is the JAX leg's."""
    from hands_tpu_torch.cli import numerics_check

    assert numerics_check.main(["--steps", "2", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("learning check")]
    assert len(lines) == 2 and "in 2 steps bs16" in lines[0]
    assert lines[1].startswith("learning check FAILED")
    cfg = numerics_check.learning_config()
    assert (cfg.backbone, cfg.lr, cfg.compute_dtype) == ("resnet18", 3e-4,
                                                         "bfloat16")
    assert not (cfg.use_render_seg_loss or cfg.use_grasp_loss
                or cfg.use_glb_feat)


def test_int8_accuracy_tool_on_the_twins(capsys):
    from hands_tpu_torch.cli import int8_accuracy

    assert int8_accuracy.main(["--device", "cpu", "--vit", "tiny",
                               "--batch", "1", "--fast_gelu"]) == 0
    assert "against int8 + fast_gelu (K5)" in capsys.readouterr().out
    rows = int8_accuracy.drift(batch=1, device="cpu", vit="tiny")
    assert "mano.vertices.r" in rows and "mano.pose.r" in rows
    for k, r in rows.items():
        assert np.isfinite(r["max"]) and 0 <= r["mean"] <= r["max"], k
    assert 0 < rows["mano.vertices.r"]["max"] < 0.05
