"""MANO hand model in PyTorch (port of ``hands_tpu/ops/mano.py``).

Shape blend, pose blend and linear blend skinning in float32 with TF32 off.
The model arrays come from the licensed ``MANO_{RIGHT,LEFT}.pkl`` under
``MANO_DIR`` when set, else from the same deterministic synthetic model as
the JAX package (bit-identical numpy arrays from the same seeds). The skinning
goes through :func:`hands_tpu_torch.ops.mano_lbs.lbs_apply`: the fused CUDA
kernel for CUDA tensors, the two plain products for CPU tensors.

Joint convention (smplx): 16 kinematic joints followed by 5 fingertip
vertices, 21 in all; joint 0 is the wrist.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops.mano_lbs import lbs_apply

NUM_VERTS = 778
NUM_FACES = 1538
NUM_JOINTS = 16
NUM_OUTPUT_JOINTS = 21
NUM_BETAS = 10

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIP_VERTEX_IDS = (744, 320, 443, 554, 671)


class ManoModel(NamedTuple):
    """MANO model tensors."""

    v_template: torch.Tensor  # (778, 3)
    shapedirs: torch.Tensor  # (778, 3, 10)
    posedirs: torch.Tensor  # (135, 778*3) pose-blend basis, pre-flattened
    j_regressor: torch.Tensor  # (16, 778)
    lbs_weights: torch.Tensor  # (778, 16)
    hand_mean: torch.Tensor  # (45,) mean pose added when flat_hand_mean=False
    faces: torch.Tensor  # (1538, 3) int32


class ManoOutput(NamedTuple):
    vertices: torch.Tensor  # (B, 778, 3)
    joints: torch.Tensor  # (B, 21, 3)


def _synthetic_model(is_rhand: bool) -> Dict[str, np.ndarray]:
    """Deterministic stand-in with MANO's exact shapes and kinematic tree:
    a wrist hub plus five finger chains along +x, vertices clustered around
    the bones. Same seeds and draws as the JAX package."""
    rng = np.random.RandomState(20240 if is_rhand else 20241)

    finger_dirs = {
        "index": np.array([1.0, 0.25, 0.0]),
        "middle": np.array([1.0, 0.05, 0.0]),
        "pinky": np.array([1.0, -0.4, 0.0]),
        "ring": np.array([1.0, -0.2, 0.0]),
        "thumb": np.array([0.7, 0.7, 0.2]),
    }
    seg = 0.03  # 3cm per phalanx
    joints = [np.zeros(3)]
    for name in ["index", "middle", "pinky", "ring", "thumb"]:
        d = finger_dirs[name] / np.linalg.norm(finger_dirs[name])
        base = d * 0.09  # knuckle 9cm from wrist
        for k in range(3):
            joints.append(base + d * seg * (k + 1))
    J = np.stack(joints)  # (16, 3)
    if not is_rhand:
        J[:, 0] *= -1.0

    per_joint = NUM_VERTS // NUM_JOINTS
    rem = NUM_VERTS - per_joint * NUM_JOINTS
    verts = []
    assign = []
    for j in range(NUM_JOINTS):
        n = per_joint + (rem if j == 0 else 0)
        verts.append(J[j] + rng.randn(n, 3) * 0.012)
        assign.extend([j] * n)
    v_template = np.concatenate(verts).astype(np.float32)
    assign = np.asarray(assign)

    W = np.full((NUM_VERTS, NUM_JOINTS), 1e-4)
    W[np.arange(NUM_VERTS), assign] = 0.8
    parents = np.asarray(PARENTS)
    par = parents[assign]
    has_parent = par >= 0
    W[np.arange(NUM_VERTS)[has_parent], par[has_parent]] = 0.2
    W = W / W.sum(axis=1, keepdims=True)

    JR = np.zeros((NUM_JOINTS, NUM_VERTS))
    for j in range(NUM_JOINTS):
        idx = np.where(assign == j)[0]
        JR[j, idx] = 1.0 / len(idx)

    shapedirs = (rng.randn(NUM_VERTS, 3, NUM_BETAS) * 0.002).astype(np.float32)
    posedirs = (rng.randn(15 * 9, NUM_VERTS * 3) * 0.0005).astype(np.float32)
    faces = rng.randint(0, NUM_VERTS, size=(NUM_FACES, 3)).astype(np.int32)

    return dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=JR.astype(np.float32),
        lbs_weights=W.astype(np.float32),
        hand_mean=np.zeros(45, np.float32),
        faces=faces,
    )


class _ChumpyShim:
    """Stand-in for ``chumpy.Ch`` when unpickling MANO assets: accepts the
    pickled attribute dict (backing array under ``'x'``) and reproduces the
    ``.r`` accessor, so the licensed files load without chumpy."""

    def __init__(self, *args, **kwargs):
        for a in args:
            if isinstance(a, np.ndarray):
                self.__dict__["x"] = a

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["x"] = state

    @property
    def r(self):
        x = self.__dict__.get("x")
        if x is None:
            raise ValueError("chumpy-pickled field carries no 'x' array; "
                             f"state keys: {sorted(self.__dict__)}")
        return np.asarray(getattr(x, "r", x))


def _mano_pickle_load(f):
    import pickle

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "chumpy":
                return _ChumpyShim
            return super().find_class(module, name)

    return _Unpickler(f, encoding="latin1").load()


def _from_mano_pkl(path: str, is_rhand: bool) -> Dict[str, np.ndarray]:
    """Arrays of a real MANO pickle (chumpy-serialised, as shipped by MPI)."""
    with open(path, "rb") as f:
        data = _mano_pickle_load(f)

    def _np(x):
        if hasattr(x, "r"):
            return np.asarray(x.r)
        if hasattr(x, "todense"):
            return np.asarray(x.todense())
        return np.asarray(x)

    shapedirs = _np(data["shapedirs"])[..., :NUM_BETAS]
    if not is_rhand:
        # the left-hand asset's shapedirs carry a mirrored x sign
        shapedirs = shapedirs * np.array([-1.0, 1.0, 1.0]).reshape(1, 3, 1)
    posedirs = _np(data["posedirs"]).reshape(NUM_VERTS * 3, -1).T
    return dict(
        v_template=_np(data["v_template"]).astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        j_regressor=_np(data["J_regressor"]).astype(np.float32),
        lbs_weights=_np(data["weights"]).astype(np.float32),
        hand_mean=_np(data["hands_mean"]).ravel().astype(np.float32),
        faces=_np(data["f"]).astype(np.int32),
    )


@functools.lru_cache(maxsize=4)
def _model_arrays(is_rhand: bool, mano_dir: str) -> Dict[str, np.ndarray]:
    name = "MANO_RIGHT.pkl" if is_rhand else "MANO_LEFT.pkl"
    path = os.path.join(mano_dir, name)
    if mano_dir and os.path.exists(path):
        return _from_mano_pkl(path, is_rhand)
    return _synthetic_model(is_rhand)


def load_mano(is_rhand: bool, flat_hand_mean: bool = False,
              device="cpu") -> ManoModel:
    """MANO model on ``device``: real assets if ``MANO_DIR`` is set, else
    synthetic. ``flat_hand_mean=False`` means the 45-dim hand pose input is
    an offset from the dataset mean pose."""
    arrays = dict(_model_arrays(is_rhand, os.environ.get("MANO_DIR", "")))
    if flat_hand_mean:
        arrays["hand_mean"] = np.zeros_like(arrays["hand_mean"])
    return ManoModel(**{k: torch.from_numpy(v).to(device)
                        for k, v in arrays.items()})


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor):
    """Forward kinematics over the MANO tree: local rotations (B, 16, 3, 3)
    and rest joints (B, 16, 3) -> posed joints (B, 16, 3) and skinning
    transforms A (B, 16, 4, 4) relative to the rest pose."""
    B = rot_mats.shape[0]
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, list(PARENTS[1:])]
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                       device=rot_mats.device).expand(B, 1, 4)

    def make_T(R, t):
        top = torch.cat([R, t[..., None]], dim=-1)  # (B, 3, 4)
        return torch.cat([top, bot], dim=-2)  # (B, 4, 4)

    transforms = [make_T(rot_mats[:, 0], rel[:, 0])]
    for j in range(1, NUM_JOINTS):
        T_local = make_T(rot_mats[:, j], rel[:, j])
        transforms.append(transforms[PARENTS[j]] @ T_local)
    T_world = torch.stack(transforms, dim=1)  # (B, 16, 4, 4)

    posed_joints = T_world[:, :, :3, 3]
    correction = torch.einsum("bjik,bjk->bji", T_world[:, :, :3, :3], joints)
    A = T_world.clone()
    A[:, :, :3, 3] = T_world[:, :, :3, 3] - correction
    return posed_joints, A


@f32_matmuls
def mano_forward(model: ManoModel, betas: torch.Tensor,
                 hand_pose: torch.Tensor, global_orient: torch.Tensor,
                 transl: torch.Tensor | None = None) -> ManoOutput:
    """(B,10) betas, (B,45) axis-angle hand pose (offset from ``hand_mean``),
    (B,3) axis-angle global orientation -> vertices + joints."""
    B = betas.shape[0]
    dtype = betas.dtype

    v_shaped = model.v_template + torch.einsum(
        "vcs,bs->bvc", model.shapedirs, betas)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)

    full_pose = torch.cat(
        [global_orient, hand_pose + model.hand_mean[None]], dim=-1)
    rot_mats = rotlib.axis_angle_to_matrix(full_pose.reshape(B, NUM_JOINTS, 3))

    ident = torch.eye(3, dtype=dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, 15 * 9)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, NUM_VERTS, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = _rigid_transform_chain(rot_mats, j_rest)

    # LBS: per-vertex transform = weights . A, applied to [v_posed, 1]
    verts = lbs_apply(v_posed.contiguous(), model.lbs_weights, A.contiguous())

    tips = verts[:, list(TIP_VERTEX_IDS), :]
    joints = torch.cat([posed_joints, tips], dim=1)  # (B, 21, 3)

    if transl is not None:
        verts = verts + transl[:, None, :]
        joints = joints + transl[:, None, :]
    return ManoOutput(vertices=verts, joints=joints)


# Wrist sealing (the wrist-ring centroid vertex + 16 closing faces) for
# watertight rendering.
SEAL_CIRCLE_V_ID = (108, 79, 78, 121, 214, 215, 279, 239, 234, 92, 38, 122,
                    118, 117, 119, 120)
_SEAL_FACES_R = np.array(
    [[a, b, NUM_VERTS] for a, b in zip(
        (SEAL_CIRCLE_V_ID[-1],) + SEAL_CIRCLE_V_ID[:-1], SEAL_CIRCLE_V_ID)],
    dtype=np.int64)


@functools.lru_cache(maxsize=2)
def _decimator_array(is_rhand: bool, data_dir: str) -> np.ndarray:
    path = os.path.join(
        data_dir, "arctic/data/arctic_data/data/meta/mano_decimator_195.npy")
    if data_dir and os.path.exists(path):
        data = np.load(path, allow_pickle=True).item()
        return np.asarray(data["D_right" if is_rhand else "D_left"],
                          np.float32)
    D = np.zeros((195, NUM_VERTS), np.float32)
    idx = np.linspace(0, NUM_VERTS - 1, 195).astype(np.int64)
    D[np.arange(195), idx] = 1.0
    return D


def load_decimator(is_rhand: bool, device="cpu") -> torch.Tensor:
    """195-vertex downsample matrix D (195, 778): ``verts_sub = D @ verts``.
    ARCTIC's ``mano_decimator_195.npy`` under ``DATA_DIR`` when present, else
    a uniform-pooling matrix of the same shape and normalisation."""
    return torch.from_numpy(
        _decimator_array(is_rhand, os.environ.get("DATA_DIR", ""))).to(device)


@f32_matmuls
def decimate_verts(verts: torch.Tensor, is_rhand: bool) -> torch.Tensor:
    """(B, 778, 3) -> (B, 195, 3) through the decimation matrix."""
    D = load_decimator(is_rhand, device=verts.device)
    return torch.einsum("sv,bvc->bsc", D, verts)


def seal_mano_mesh(v3d: torch.Tensor, faces: torch.Tensor, is_rhand: bool):
    """Append the wrist-ring centroid vertex and the 16 sealing faces:
    v3d (B, 778, 3), faces (1538, 3) -> (B, 779, 3), (1554, 3)."""
    seal_faces = _SEAL_FACES_R if is_rhand else _SEAL_FACES_R[:, [1, 0, 2]]
    centers = v3d[:, list(SEAL_CIRCLE_V_ID)].mean(dim=1, keepdim=True)
    sealed = torch.cat([v3d, centers], dim=1)
    all_faces = torch.cat(
        [faces, torch.as_tensor(seal_faces, dtype=faces.dtype,
                                device=faces.device)], dim=0)
    return sealed, all_faces
