"""Port parity of ARCTIC's offline ground-truth build
(``data/arctic_processing.py``) against the JAX package: the same raw
6-frame sequences (``tests/test_arctic_processing.py:_fake_seq`` layout,
with and without ``smplx.npy``, and with rotated cameras and a distorted
egocam) through ``process_seq`` in both packages, then ``build_split`` over
two sequences.

Tolerances: 3D (``cam_coord``) 1e-5 m; 2D and the boxes' centres 1e-2 px
(the box scale, side / 200 px, at 1e-2 / 200); validity flags and the
parameters equal. The body of ``_add_smplx`` is moved 1 m away from the
cameras: as written it straddles their planes, where a projection divides
by depths near the 1e-9 clamp and an ulp of 3D moves pixels by tenths.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.data import arctic_processing as jap
from hands_tpu_torch.data import arctic_processing as tap
from test_arctic_processing import _add_smplx, _fake_seq

M_TOL, PX_TOL = 1e-5, 1e-2


def _distort_cameras(seq_dir, seed=3):
    """Rotated, translated cameras and 8 distortion coefficients in the
    sequence's ``misc.json``."""
    from hands_tpu_torch.core.rot import axis_angle_to_matrix

    meta = os.path.join(os.path.dirname(os.path.dirname(seq_dir)),
                        "meta/misc.json")
    with open(meta) as f:
        misc = json.load(f)
    rng = np.random.RandomState(seed)
    V = len(misc["s01"]["world2cam"])
    w2c = np.tile(np.eye(4), (V, 1, 1))
    w2c[:, :3, :3] = axis_angle_to_matrix(torch.from_numpy(
        (rng.randn(V, 3) * 0.1).astype(np.float32))).numpy()
    w2c[:, :3, 3] = rng.randn(V, 3) * 0.05 + [0, 0, 0.2]
    misc["s01"]["world2cam"] = w2c.tolist()
    misc["s01"]["dist8"] = (rng.randn(8) * [0.05, 0.01, 1e-3, 1e-3, 1e-3,
                                            0.02, 5e-3, 1e-3]).tolist()
    with open(meta, "w") as f:
        json.dump(misc, f)


def _add_body(seq_dir):
    """``_add_smplx``'s bundle with the body 1 m in front of the cameras."""
    _add_smplx(seq_dir)
    path = os.path.join(seq_dir, "smplx.npy")
    smplx = np.load(path, allow_pickle=True).item()
    smplx["transl"] = smplx["transl"] + np.float32([0.0, 0.0, 1.0])
    np.save(path, smplx)


def _second_seq(seq_dir, name="box_use_02", seed=5):
    """A second sequence of the same subject: the first one's raw files
    with perturbed parameters."""
    rng = np.random.RandomState(seed)
    other = os.path.join(os.path.dirname(seq_dir), name)
    os.makedirs(other)
    mano = np.load(os.path.join(seq_dir, "mano.npy"), allow_pickle=True).item()
    for hand in mano.values():
        hand["pose"] = (hand["pose"] + rng.randn(*hand["pose"].shape) * 0.05
                        ).astype(np.float32)
    np.save(os.path.join(other, "mano.npy"), mano)
    obj = np.load(os.path.join(seq_dir, "obj.npy"))
    np.save(os.path.join(other, "obj.npy"),
            (obj + rng.randn(*obj.shape) * 0.01).astype(np.float32))
    smplx = os.path.join(seq_dir, "smplx.npy")
    if os.path.exists(smplx):
        shutil.copy(smplx, other)
    return other


def _hold(got, ref):
    """The payload of the port against the JAX one."""
    assert set(got) == set(ref)
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k])
    assert set(got["2d"]) == set(ref["2d"])
    for k in ref["2d"]:
        assert got["2d"][k].shape == ref["2d"][k].shape
        np.testing.assert_allclose(got["2d"][k], ref["2d"][k], rtol=0,
                                   atol=PX_TOL, err_msg=k)
    assert set(got["cam_coord"]) == set(ref["cam_coord"])
    for k in ref["cam_coord"]:
        np.testing.assert_allclose(got["cam_coord"][k], ref["cam_coord"][k],
                                   rtol=0, atol=M_TOL, err_msg=k)
    np.testing.assert_allclose(got["bbox"] * [1, 1, 200],
                               ref["bbox"] * [1, 1, 200], rtol=0,
                               atol=PX_TOL)
    for k in ("joints_valid_r", "joints_valid_l", "right_valid",
              "left_valid"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("smplx,distorted", [(False, False), (True, False),
                                             (True, True)])
def test_process_seq_and_split_match_jax(tmp_path, smplx, distorted):
    seq = _fake_seq(tmp_path)
    if smplx:
        _add_body(seq)
    if distorted:
        _distort_cameras(seq)
    seqs = [seq, _second_seq(seq)]
    names = []
    for s in seqs:
        for pkg, out in ((jap, "jax"), (tap, "torch")):
            kw = {} if pkg is jap else {"device": "cpu"}
            p = pkg.process_seq(s, str(tmp_path / out), export_verts=True,
                                **kw)
        names.append(os.path.splitext(os.path.basename(p))[0])
        ref = np.load(tmp_path / "jax" / f"{names[-1]}.npy",
                      allow_pickle=True).item()
        got = np.load(tmp_path / "torch" / f"{names[-1]}.npy",
                      allow_pickle=True).item()
        _hold(got, ref)
        assert ("joints.smplx" in got["cam_coord"]) == smplx
        assert ("verts.smplx" in got["2d"]) == smplx
    split = {}
    for pkg, out in ((jap, "jax"), (tap, "torch")):
        p = pkg.build_split(str(tmp_path / out), names, "p2", "train",
                            str(tmp_path / out / "splits"))
        split[out] = np.load(p, allow_pickle=True).item()
    _hold(split["torch"], split["jax"])
    assert split["torch"]["2d"]["joints.right"].shape[0] == 12
    # without export_verts the vertex sets stay out of the 2D payload
    p = tap.process_seq(seq, str(tmp_path / "novert"), device="cpu")
    data = np.load(p, allow_pickle=True).item()
    assert not [k for k in data["2d"] if "verts" in k]


def test_stages_match_jax():
    """``compute_bbox_from_kp2d``, ``forward_define_bbox`` and
    ``forward_valid`` on the same 2D inputs; ``forward_world2cam`` with
    per-frame extrinsics (V, T, 4, 4)."""
    rng = np.random.RandomState(0)
    kp = (rng.rand(4, 3, 30, 2) * [2800, 2000]).astype(np.float32)
    for s in (0.0, 0.6):
        np.testing.assert_allclose(
            tap.compute_bbox_from_kp2d(torch.from_numpy(kp), s).numpy(),
            np.asarray(jap.compute_bbox_from_kp2d(jnp.asarray(kp), s)),
            rtol=1e-6)
    out2d = {"verts.object": kp}
    box_t = tap.forward_define_bbox({"verts.object": torch.from_numpy(kp)})
    box_j = np.asarray(jap.forward_define_bbox(
        {k: jnp.asarray(v) for k, v in out2d.items()}))
    np.testing.assert_allclose(box_t.numpy(), box_j, rtol=1e-6)
    j2d = (rng.rand(4, 3, 21, 2) * [3000, 2200] - 100).astype(np.float32)
    sizes = np.asarray([[2800, 2000]] * 3)
    vt = tap.forward_valid(box_t, torch.from_numpy(j2d),
                           torch.from_numpy(j2d[..., ::-1, :].copy()),
                           torch.from_numpy(sizes))
    vj = jap.forward_valid(jnp.asarray(box_j), jnp.asarray(j2d),
                           jnp.asarray(j2d[..., ::-1, :]), jnp.asarray(sizes))
    for k in vj:
        np.testing.assert_array_equal(vt[k].numpy(), np.asarray(vj[k]))
    pts = (rng.randn(4, 21, 3) * 0.1).astype(np.float32)
    aa = (rng.randn(4, 3) * 0.3).astype(np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 4, 1, 1))
    w2c[..., :3, 3] = rng.randn(2, 4, 3) * 0.1
    got = tap.forward_world2cam(
        {"joints.right": torch.from_numpy(pts),
         "rot_r_world": torch.from_numpy(aa)}, torch.from_numpy(w2c))
    ref = jap.forward_world2cam(
        {"joints.right": jnp.asarray(pts), "rot_r_world": jnp.asarray(aa)},
        jnp.asarray(w2c))
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"joints.right", "rot_r_cam"}
        for k in r:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=0, atol=M_TOL)
