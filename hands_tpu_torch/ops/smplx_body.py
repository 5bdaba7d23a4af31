"""SMPL-X body model: shape blend, pose blend and linear blend skinning
over the 55-joint tree (port of ``hands_tpu/ops/smplx_body.py``).

The body forward of ARCTIC's ground-truth build
(``data/arctic_processing.py:forward_gt_world``). The same machinery as
``ops/mano.py`` at body scale: one shape-blend einsum, one pose-blend
matmul, the kinematic chain unrolled over the static tree, and the LBS as
one einsum. The LBS stays an einsum, as in the JAX package (outside any
Pallas kernel); MANO's kernel is built for 778 vertices and 16 joints.
float32 with TF32 off.

Real assets: ``SMPLX_DIR`` holding ``SMPLX_NEUTRAL.npz`` (or
``SMPLX_MALE/FEMALE.npz``) as shipped by MPI; otherwise the synthetic model
of the JAX package (seed 11, the real field shapes, array for array).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls

NUM_JOINTS = 55  # 22 body + jaw + 2 eyes + 2x15 fingers
NUM_BODY_JOINTS = 21  # body_pose covers joints 1..21
NUM_VERTS = 10475
NUM_BETAS = 10

# The SMPL-X kinematic tree (smplx kintree_table): 0 pelvis; 1/2 hips;
# 3 spine1; 4/5 knees; 6 spine2; 7/8 ankles; 9 spine3; 10/11 feet; 12 neck;
# 13/14 collars; 15 head; 16/17 shoulders; 18/19 elbows; 20/21 wrists;
# 22 jaw; 23/24 eyes; 25-39 left fingers (parented to wrist 20); 40-54
# right fingers (parented to wrist 21).
PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)
assert len(PARENTS) == NUM_JOINTS


class BodyModel(NamedTuple):
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, NUM_BETAS)
    posedirs: torch.Tensor  # ((J-1)*9, V*3)
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    faces: torch.Tensor  # (F, 3)
    # PCA bases of the 45-dim hand poses (identity: axis-angle input, i.e.
    # smplx use_pca=False)
    hands_components_l: torch.Tensor  # (45, 45)
    hands_components_r: torch.Tensor  # (45, 45)
    hands_mean_l: torch.Tensor  # (45,)
    hands_mean_r: torch.Tensor  # (45,)


class BodyOutput(NamedTuple):
    vertices: torch.Tensor  # (B, V, 3)
    joints: torch.Tensor  # (B, 55, 3) FK skeleton joints


def _synthetic_body_model(seed: int = 11,
                          num_verts: int = NUM_VERTS) -> dict:
    """Field-faithful random body model: a plausible rest skeleton,
    dominant-joint skinning, small smooth blend bases. The same draws as
    the JAX package."""
    rng = np.random.RandomState(seed)
    J, V = NUM_JOINTS, num_verts

    parents = np.asarray(PARENTS)
    offsets = rng.randn(J, 3) * 0.08
    offsets[0] = 0.0
    joints = np.zeros((J, 3))
    for j in range(1, J):
        joints[j] = joints[parents[j]] + offsets[j]

    assign = rng.randint(0, J, size=V)
    v_template = (joints[assign] + rng.randn(V, 3) * 0.03).astype(np.float32)

    W = np.full((V, J), 1e-4)
    W[np.arange(V), assign] = 0.8
    par = parents[assign]
    has_parent = par >= 0
    W[np.arange(V)[has_parent], par[has_parent]] = 0.2
    W = W / W.sum(axis=1, keepdims=True)

    JR = np.zeros((J, V))
    counts = np.bincount(assign, minlength=J).astype(np.float64)
    counts[counts == 0] = 1.0
    JR[assign, np.arange(V)] = 1.0 / counts[assign]
    # joints with no assigned vertex regress from all of them equally
    empty = np.bincount(assign, minlength=J) == 0
    JR[empty] = 1.0 / V

    shapedirs = (rng.randn(V, 3, NUM_BETAS) * 0.002).astype(np.float32)
    posedirs = (rng.randn((J - 1) * 9, V * 3) * 0.0002).astype(np.float32)
    faces = rng.randint(0, V, size=(20908, 3)).astype(np.int32)

    eye45 = np.eye(45, dtype=np.float32)
    return dict(
        v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
        j_regressor=JR.astype(np.float32), lbs_weights=W.astype(np.float32),
        faces=faces, hands_components_l=eye45, hands_components_r=eye45,
        hands_mean_l=np.zeros(45, np.float32),
        hands_mean_r=np.zeros(45, np.float32))


def _to_model(arrays: dict, device) -> BodyModel:
    return BodyModel(**{k: torch.from_numpy(v).to(device)
                        for k, v in arrays.items()})


def _from_smplx_npz(path: str, use_pca: bool, flat_hand_mean: bool,
                    v_template: np.ndarray | None = None,
                    device="cpu") -> BodyModel:
    """Load an MPI ``SMPLX_*.npz``. ARCTIC bakes a subject's shape into a
    subject template; pass it as ``v_template`` to override the npz's."""
    return _to_model(_npz_arrays(path, use_pca, flat_hand_mean, v_template),
                     device)


def _npz_arrays(path: str, use_pca: bool, flat_hand_mean: bool,
                v_template: np.ndarray | None = None) -> dict:
    """The model arrays of an MPI ``SMPLX_*.npz``, float32."""
    data = np.load(path, allow_pickle=True)

    def g(key):
        return np.asarray(data[key])

    shapedirs = g("shapedirs")[..., :NUM_BETAS]
    posedirs = g("posedirs")  # (V, 3, (J-1)*9)
    posedirs = posedirs.reshape(posedirs.shape[0] * 3, -1).T
    comp_l = g("hands_componentsl")[:45] if use_pca else np.eye(45)
    comp_r = g("hands_componentsr")[:45] if use_pca else np.eye(45)
    mean_l = np.zeros(45) if flat_hand_mean else g("hands_meanl")
    mean_r = np.zeros(45) if flat_hand_mean else g("hands_meanr")
    vt = v_template if v_template is not None else g("v_template")
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(
        v_template=f32(vt), shapedirs=f32(shapedirs), posedirs=f32(posedirs),
        j_regressor=f32(g("J_regressor")[:NUM_JOINTS]),
        lbs_weights=f32(g("weights")[:, :NUM_JOINTS]),
        faces=g("f").astype(np.int32),
        hands_components_l=f32(comp_l), hands_components_r=f32(comp_r),
        hands_mean_l=f32(mean_l.ravel()), hands_mean_r=f32(mean_r.ravel()))


@functools.lru_cache(maxsize=4)
def _model_arrays(gender: str, use_pca: bool, flat_hand_mean: bool,
                  smplx_dir: str) -> dict:
    path = os.path.join(smplx_dir, f"SMPLX_{gender.upper()}.npz")
    if smplx_dir and os.path.exists(path):
        return _npz_arrays(path, use_pca, flat_hand_mean)
    return _synthetic_body_model()


def load_body_model(gender: str = "neutral", use_pca: bool = False,
                    flat_hand_mean: bool = True, device="cpu") -> BodyModel:
    """The body model on ``device``: ``SMPLX_DIR``'s npz when present, else
    the synthetic model."""
    return _to_model(_model_arrays(gender, use_pca, flat_hand_mean,
                                   os.environ.get("SMPLX_DIR", "")), device)


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor):
    """FK over the static SMPL-X tree, unrolled to a fixed DAG of 4x4
    products (depth <= 8): local rotations (B, 55, 3, 3) and rest joints
    (B, 55, 3) -> posed joints (B, 55, 3) and skinning transforms A
    (B, 55, 4, 4) relative to the rest pose."""
    B = rot_mats.shape[0]
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, list(PARENTS[1:])]
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                       device=rot_mats.device).expand(B, 1, 4)

    def make_T(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bot], dim=-2)

    transforms = [make_T(rot_mats[:, 0], rel[:, 0])]
    for j in range(1, NUM_JOINTS):
        transforms.append(transforms[PARENTS[j]] @ make_T(rot_mats[:, j],
                                                          rel[:, j]))
    T_world = torch.stack(transforms, dim=1)  # (B, 55, 4, 4)

    posed_joints = T_world[:, :, :3, 3]
    correction = torch.einsum("bjik,bjk->bji", T_world[:, :, :3, :3], joints)
    A = T_world.clone()
    A[:, :, :3, 3] = T_world[:, :, :3, 3] - correction
    return posed_joints, A


@f32_matmuls
def body_forward(
    model: BodyModel,
    global_orient: torch.Tensor,  # (B, 3)
    body_pose: torch.Tensor,  # (B, 63)
    jaw_pose: torch.Tensor,  # (B, 3)
    leye_pose: torch.Tensor,  # (B, 3)
    reye_pose: torch.Tensor,  # (B, 3)
    left_hand_pose: torch.Tensor,  # (B, 45) axis-angle, or PCA if use_pca
    right_hand_pose: torch.Tensor,  # (B, 45)
    transl: torch.Tensor | None = None,  # (B, 3)
    betas: torch.Tensor | None = None,  # (B, 10)
) -> BodyOutput:
    """SMPL-X forward on the parameter bundle of ARCTIC's ``smplx.npy``.
    The joints are the 55 FK skeleton joints (the smplx package appends
    face and feet landmarks up to 127; ARCTIC's build only carries joints
    through world -> camera -> 2D, so the skeleton is the contract)."""
    B = global_orient.shape[0]
    dtype = global_orient.dtype

    if betas is None:
        v_shaped = model.v_template.expand((B,) + model.v_template.shape)
    else:
        v_shaped = model.v_template + torch.einsum(
            "vcs,bs->bvc", model.shapedirs, betas)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)

    lhand = model.hands_mean_l[None] + \
        left_hand_pose @ model.hands_components_l
    rhand = model.hands_mean_r[None] + \
        right_hand_pose @ model.hands_components_r
    full_pose = torch.cat([global_orient, body_pose, jaw_pose, leye_pose,
                           reye_pose, lhand, rhand], dim=-1)  # (B, 165)
    rot_mats = rotlib.axis_angle_to_matrix(full_pose.reshape(B, NUM_JOINTS, 3))

    ident = torch.eye(3, dtype=dtype, device=global_orient.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, (NUM_JOINTS - 1) * 9)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = _rigid_transform_chain(rot_mats, j_rest)

    T = torch.einsum("vj,bjrc->bvrc", model.lbs_weights, A)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvrc,bvc->bvr", T, v_homo)[..., :3]

    if transl is not None:
        verts = verts + transl[:, None, :]
        posed_joints = posed_joints + transl[:, None, :]
    return BodyOutput(vertices=verts, joints=posed_joints)
