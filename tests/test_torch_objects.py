"""Port parity of the object, body and geometry remainder against the JAX
package, on the same seeded numpy inputs:

- the core remainder (``core/transforms``: ``solve_rigid_tf``,
  ``distort_pts3d``; ``core/rot``: the quaternion algebra and the SPIN and
  HaMeR 6D encodings; ``core/camera``: the DLT translation solves, look-at,
  sphere poses, coordinate maps, intrinsics): 1e-6 of max(1, |ref|);
- ``core/tree_utils`` (exact, but ``nanmean`` at 1e-6: its f32 sum runs
  in each library's own order) and ``core/mesh`` (``export_obj``
  byte-equal);
- the object set (array for array) and ``object_forward_7d`` (1e-5 m after
  the mm -> m scale, i.e. 1e-2 on the mm templates);
- ``ops/knn``: distances at 1e-4 abs (the JAX test's bound for the matmul
  form's cancellation), indices where the nearest two distances differ by
  more than that;
- SMPL-X: the synthetic model array for array, ``body_forward`` at 1e-5 m;
- ``train/process_object`` at 1e-5;
- ``train/metrics_object``: each evaluation at 1e-5 relative, the contact
  windows equal.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.core import camera as jcam
from hands_tpu.core import mesh as jmesh
from hands_tpu.core import object_tensors as jobj
from hands_tpu.core import rot as jrot
from hands_tpu.core import transforms as jtf
from hands_tpu.core import tree_utils as jtree
from hands_tpu.core.xdict import XDict as JXDict
from hands_tpu.ops import knn as jknn
from hands_tpu.ops import mano as jmano
from hands_tpu.ops import smplx_body as jsb
from hands_tpu.train import metrics_object as jmo
from hands_tpu.train import process_object as jpo
from hands_tpu_torch.core import camera as tcam
from hands_tpu_torch.core import mesh as tmesh
from hands_tpu_torch.core import object_tensors as tobj
from hands_tpu_torch.core import rot as trot
from hands_tpu_torch.core import transforms as ttf
from hands_tpu_torch.core import tree_utils as ttree
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import knn as tknn
from hands_tpu_torch.ops import mano as tmano
from hands_tpu_torch.ops import smplx_body as tsb
from hands_tpu_torch.train import metrics_object as tmo
from hands_tpu_torch.train import process_object as tpo

CORE_TOL = 1e-6  # relative to max(1, |ref|)
M_TOL = 1e-5  # metres
REL = 1e-5  # metrics


def close(got, ref, tol, scale=True):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    denom = np.maximum(1.0, np.abs(ref[fin])) if scale else 1.0
    err = np.abs(got[fin].astype(np.float64) - ref[fin]) / denom
    assert err.size == 0 or err.max() <= tol, err.max()


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


# ------------------------------------------------------------ core remainder
def _quats(rng, n=16):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotations(rng, n=16):
    return np.asarray(jrot.axis_angle_to_matrix(
        j(rng.randn(n, 3).astype(np.float32))))


def _core_cases():
    rng = np.random.RandomState(0)
    qa, qb = _quats(rng), _quats(rng)
    pts = rng.randn(16, 3).astype(np.float32)
    R = _rotations(rng)
    d6 = rng.randn(16, 6).astype(np.float32)
    A = rng.randn(5, 30, 3).astype(np.float32)
    B = A @ np.swapaxes(_rotations(rng, 5), 1, 2) + rng.randn(5, 1, 3)
    B = (B + rng.randn(*B.shape) * 1e-3).astype(np.float32)
    A[1] = A[1] * np.array([1, 1, -1], np.float32)  # the reflection fix
    cam = (rng.randn(4, 50, 3) * [0.2, 0.2, 0.05] + [0, 0, 0.6]).astype(
        np.float32)
    dist = (rng.randn(8) * [0.1, 0.02, 1e-3, 1e-3, 1e-3, 0.05, 0.01, 1e-3]
            ).astype(np.float32)
    S = (rng.randn(3, 21, 3) * 0.05).astype(np.float32)
    kp = (rng.rand(3, 21, 2) * 224).astype(np.float32)
    conf = rng.rand(3, 21).astype(np.float32)
    K = np.tile(np.asarray([[900.0, 0, 110], [0, 950.0, 118], [0, 0, 1]],
                           np.float32), (3, 1, 1))
    eye = rng.randn(6, 3).astype(np.float32)
    uv = rng.rand(2, 7).astype(np.float32)
    aa = (rng.randn(6, 3) * 0.5).astype(np.float32)
    return {
        "quaternion_raw_multiply": (
            lambda m, c: m.quaternion_raw_multiply(c(qa), c(qb)), "rot"),
        "quaternion_multiply": (
            lambda m, c: m.quaternion_multiply(c(qa), c(qb)), "rot"),
        "quaternion_invert": (lambda m, c: m.quaternion_invert(c(qa)), "rot"),
        "quaternion_apply": (
            lambda m, c: m.quaternion_apply(c(qa), c(pts)), "rot"),
        "rot6d_to_matrix_spin": (
            lambda m, c: m.rot6d_to_matrix_spin(c(d6)), "rot"),
        "matrix_to_rot6d_spin": (
            lambda m, c: m.matrix_to_rot6d_spin(c(R)), "rot"),
        "matrix_to_rot6d_hamer": (
            lambda m, c: m.matrix_to_rot6d_hamer(c(R)), "rot"),
        "solve_rigid_tf": (lambda m, c: m.solve_rigid_tf(c(A), c(B)), "tf"),
        "distort_pts3d": (lambda m, c: m.distort_pts3d(c(cam), c(dist)), "tf"),
        "distort_pts3d_batched": (lambda m, c: m.distort_pts3d(
            c(cam), c(np.tile(dist, (4, 1)))), "tf"),
        "estimate_translation": (lambda m, c: m.estimate_translation(
            c(S), c(kp), c(conf), 5000.0, 224), "cam"),
        "estimate_translation_k": (lambda m, c: m.estimate_translation_k(
            c(S), c(kp), c(conf), c(K)), "cam"),
        "unnormalize_kp2d": (
            lambda m, c: m.unnormalize_kp2d(c(kp / 112 - 1), 224), "cam"),
        "weak_perspective_intrinsics": (
            lambda m, c: m.weak_perspective_intrinsics(5000.0, 224), "cam"),
        "get_default_cam_t": (
            lambda m, c: m.get_default_cam_t(5000.0, 224), "cam"),
        "get_coord_maps": (lambda m, c: m.get_coord_maps(56), "cam"),
        "look_at": (lambda m, c: m.look_at(c(eye)), "cam"),
        "look_at_up": (lambda m, c: m.look_at(
            c(eye), at=c(np.float32([0.1, 0, 0.2])),
            up=c(np.float32([0, 1.0, 0]))), "cam"),
        "to_sphere": (lambda m, c: m.to_sphere(c(uv[0]), c(uv[1])), "cam"),
        "rectify_pose": (lambda m, c: m.rectify_pose(c(R[0]), c(aa)), "cam"),
        "rectify_pose_x": (lambda m, c: m.rectify_pose(
            c(R[1]), c(aa), rotate_x=True), "cam"),
    }


CORE = _core_cases()
MODULES = {"rot": (jrot, trot), "tf": (jtf, ttf), "cam": (jcam, tcam)}


@pytest.mark.parametrize("name", sorted(CORE))
def test_core_remainder_matches_jax(name):
    fn, mod = CORE[name]
    jm, tm = MODULES[mod]
    ref, got = fn(jm, j), fn(tm, t)
    if isinstance(ref, tuple):
        for r, g in zip(ref, got):
            close(g, r, CORE_TOL)
    else:
        close(got, ref, CORE_TOL)


def test_sample_pose_on_sphere_is_a_look_at_pose():
    """The JAX function draws (u, v) from a PRNG key, the port's from a
    generator: the pose is checked for what it is, a rotation whose z axis
    points from the origin to its position on the sphere."""
    gen = torch.Generator().manual_seed(0)
    pose = tcam.sample_pose_on_sphere(gen, radius=2.0)
    R, loc = pose[:, :3], pose[:, 3]
    torch.testing.assert_close(R @ R.T, torch.eye(3), atol=1e-6, rtol=0)
    assert abs(float(torch.linalg.norm(loc)) - 2.0) < 1e-6
    torch.testing.assert_close(R[:, 2], loc / 2.0, atol=1e-6, rtol=0)
    close(R, jcam.look_at(j(loc[None].numpy()), up=j([0.0, 1.0, 0.0]))[0],
          CORE_TOL)


# ----------------------------------------------------------- tree and mesh
def test_tree_utils_match_jax():
    rng = np.random.RandomState(1)
    ld = [{"a": rng.randn(2, 3).astype(np.float32), "b": [i, i + 1],
           "c": f"s{i}"} for i in range(3)]
    dl_j, dl_t = jtree.ld2dl(ld), ttree.ld2dl(ld)
    assert dl_j.keys() == dl_t.keys()
    for got, ref in ((ttree.cat_dl(dl_t), jtree.cat_dl(dl_j)),
                     (ttree.stack_dl(dl_t), jtree.stack_dl(dl_j))):
        assert got.keys() == ref.keys()
        np.testing.assert_array_equal(got["a"], ref["a"])
        assert got["b"] == ref["b"] and got["c"] == ref["c"]
    # tensors in the lists concatenate like arrays
    dl_tensor = {"a": [torch.from_numpy(d["a"]) for d in ld]}
    np.testing.assert_array_equal(ttree.cat_dl(dl_tensor)["a"],
                                  jtree.cat_dl(dl_j)["a"])
    back_j = jtree.dl2ld(dl_j)
    back_t = ttree.dl2ld(dl_t)
    assert [d["c"] for d in back_t] == [d["c"] for d in back_j]
    assert ttree.prefix_dict({"x": 1}, "p.") == jtree.prefix_dict({"x": 1},
                                                                   "p.")
    order = [3, 0, 2, 1]
    assert ttree.unsort(list("abcd"), order) == jtree.unsort(list("abcd"),
                                                             order)
    for n in (1, 3, 4, 7):
        assert ttree.chunks_by_len(range(10), n) == \
            jtree.chunks_by_len(range(10), n)
        assert ttree.chunks_by_size(range(10), n) == \
            jtree.chunks_by_size(range(10), n)
    x2, y2 = rng.randn(3, 2).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    np.testing.assert_array_equal(ttree.all_comb(t(x2), t(y2)).numpy(),
                                  np.asarray(jtree.all_comb(j(x2), j(y2))))
    i1, i2 = np.arange(3), np.arange(2)
    np.testing.assert_array_equal(ttree.all_comb(t(i1), t(i2)).numpy(),
                                  np.asarray(jtree.all_comb(j(i1), j(i2))))
    nan = rng.randn(4, 5).astype(np.float32)
    nan[0] = np.nan
    nan[1, :3] = np.inf
    for axis in (None, 0, 1):
        # f32 sums in the two libraries' own orders
        close(ttree.nanmean(t(nan), dim=axis),
              jtree.nanmean(j(nan), axis=axis), CORE_TOL)
    ragged = [rng.randn(n, 3).astype(np.float32) for n in (2, 5, 1)]
    (pj, lj), (pt, lt) = jtree.pad_tensor_list(ragged), \
        ttree.pad_tensor_list([t(r) for r in ragged])
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(lt, lj)
    for a, b in zip(ttree.unpad_vtensor(t(pt), lt),
                    jtree.unpad_vtensor(pj, lj)):
        np.testing.assert_array_equal(a, b)
    lin = torch.nn.Linear(3, 4)
    bn = torch.nn.BatchNorm1d(4)
    assert ttree.count_params(lin) == jtree.count_params(
        {"w": np.zeros((3, 4)), "b": np.zeros(4)}) == 16
    # parameters and buffers (running statistics, the step count)
    assert ttree.count_params(bn) == 4 * 4 + 1


def test_mesh_cat_and_export_are_byte_equal(tmp_path):
    rng = np.random.RandomState(2)
    parts = []
    for mod in (jmesh, tmesh):
        a = mod.Mesh(rng.randn(5, 3), [[0, 1, 2], [2, 3, 4]])
        b = mod.Mesh(rng.randn(3, 3), [[0, 1, 2]]).set_vc([1.0, 0.2, 0.1])
        parts.append(mod.Mesh.cat([a, b]))
        rng = np.random.RandomState(2)
    (jm, tm) = parts
    pj, pt = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    jm.export_obj(pj)
    tm.export_obj(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert tm.f.max() == 7 and tm.f.dtype == np.int64


# ----------------------------------------------------------------- objects
def test_object_set_equals_jax_array_for_array():
    ref = jobj.build_object_tensors()
    got = tobj.build_object_tensors()
    assert ref._fields == got._fields
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert tobj.OBJECTS == jobj.OBJECTS


def test_object_set_from_arctic_templates(tmp_path, monkeypatch):
    """``$DATA_DIR``'s templates (an OBJ and parts.json a part) replace the
    synthetic meshes, as in the JAX package."""
    base = tmp_path / "arctic/data/arctic_data/data/meta/object_vtemplates"
    rng = np.random.RandomState(3)
    for name in ("box", "phone"):
        d = base / name
        os.makedirs(d)
        v = rng.randn(40, 3) * 30
        with open(d / "mesh.obj", "w") as f:
            for p in v:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            for k in range(38):
                f.write(f"f {k + 1}/1 {k + 2}/1 {k + 3}/1\n")
        with open(d / "parts.json", "w") as f:
            f.write(str([int(z > 0) for z in v[:, 2]]))
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    jobj.build_object_tensors.cache_clear()
    try:
        ref = jobj.build_object_tensors()
        got = tobj.build_object_tensors()
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        assert int(got.v_len[tobj.OBJECTS.index("box")]) == 40
    finally:
        jobj.build_object_tensors.cache_clear()


def _object_pose(rng, B):
    return (rng.rand(B, 1).astype(np.float32) * 1.5,
            (rng.randn(B, 3) * 0.7).astype(np.float32),
            (rng.randn(B, 3) * 100).astype(np.float32),
            np.arange(B) % len(tobj.OBJECTS))


@pytest.mark.parametrize("with_transl", [True, False])
def test_object_forward_7d_matches_jax(with_transl):
    rng = np.random.RandomState(4)
    angles, orient, transl, idx = _object_pose(rng, 11)
    transl = transl if with_transl else None
    ref = jobj.object_forward_7d(
        jobj.build_object_tensors(), j(angles), j(orient),
        None if transl is None else j(transl), j(idx))
    got = tobj.object_forward_7d(
        tobj.build_object_tensors(), t(angles), t(orient),
        None if transl is None else t(transl), t(idx))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("v", "v_sub", "bbox3d", "kp3d"):
            # mm templates: 1e-5 m is 1e-2 mm
            close(got[k], ref[k], M_TOL * 1000, scale=False)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert list(tobj.object_names_to_idx(["phone", "box"])) == \
        list(jobj.object_names_to_idx(["phone", "box"]))


# --------------------------------------------------------------------- knn
def _hand_object(rng, B=3):
    tensors = jobj.build_object_tensors()
    idx = np.asarray([1, 5, 10])[:B]
    v_o = (np.asarray(tensors.v)[idx] / 1000.0).astype(np.float32)
    v_len = np.asarray(tensors.v_len)[idx]
    v_h = (rng.randn(B, 778, 3) * 0.04).astype(np.float32)
    return v_h, v_o, v_len


def test_knn_matches_jax():
    rng = np.random.RandomState(5)
    v_h, v_o, v_len = _hand_object(rng)
    for q, p, n in ((v_h, v_o, v_len), (v_o, v_h, None)):
        dj, ij = jknn.knn(j(q), j(p), None if n is None else j(n), k=2)
        dt, it = tknn.knn(t(q), t(p), None if n is None else t(n), k=2)
        dj, ij = np.asarray(dj), np.asarray(ij)
        close(dt, dj, 1e-4, scale=False)
        clear = (dj[..., 1] - dj[..., 0]) > 1e-4
        np.testing.assert_array_equal(it.numpy()[..., 0][clear],
                                      ij[..., 0][clear])
        assert clear.mean() > 0.9
    # padded points never win
    _, it = tknn.knn(t(v_h), t(v_o), t(v_len), k=1)
    assert (it[..., 0] < t(v_len)[:, None]).all()
    d, i = tknn.compute_dist_mano_to_obj(t(v_h), t(v_o), t(v_len), 0.0, 0.1)
    dj, ij = jknn.compute_dist_mano_to_obj(j(v_h), j(v_o), j(v_len), 0.0,
                                           0.1)
    close(d, dj, 1e-4, scale=False)
    np.testing.assert_array_equal(
        tknn.dist2contact(d, 0.01).numpy(),
        np.asarray(jknn.dist2contact(j(d.numpy()), 0.01)))


# ------------------------------------------------------------------ SMPL-X
def _body_params(rng, B=3, betas=True):
    f = lambda n, s: (rng.randn(B, n) * s).astype(np.float32)  # noqa: E731
    kw = dict(global_orient=f(3, 0.3), body_pose=f(63, 0.2),
              jaw_pose=f(3, 0.1), leye_pose=f(3, 0.1), reye_pose=f(3, 0.1),
              left_hand_pose=f(45, 0.3), right_hand_pose=f(45, 0.3),
              transl=f(3, 0.5))
    if betas:
        kw["betas"] = f(10, 0.5)
    return kw


def test_body_model_equals_jax_array_for_array():
    ref = jsb.load_body_model()
    got = tsb.load_body_model()
    assert ref._fields == got._fields
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert got.v_template.shape == (tsb.NUM_VERTS, 3)
    assert got.j_regressor.shape == (tsb.NUM_JOINTS, tsb.NUM_VERTS)


@pytest.mark.parametrize("betas", [True, False])
def test_body_forward_matches_jax(betas):
    kw = _body_params(np.random.RandomState(6), betas=betas)
    ref = jsb.body_forward(jsb.load_body_model(),
                           **{k: j(v) for k, v in kw.items()})
    got = tsb.body_forward(tsb.load_body_model(),
                           **{k: t(v) for k, v in kw.items()})
    close(got.vertices, ref.vertices, M_TOL, scale=False)
    close(got.joints, ref.joints, M_TOL, scale=False)


def test_body_npz_loader_matches_jax(tmp_path):
    """An MPI-layout npz (random fields of the real shapes, 300 vertices)
    read by both loaders, with and without the PCA hand bases."""
    rng = np.random.RandomState(7)
    V, J = 300, 55
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    np.savez(path, v_template=rng.randn(V, 3),
             shapedirs=rng.randn(V, 3, 20) * 0.01,
             posedirs=rng.randn(V, 3, (J - 1) * 9) * 1e-3,
             J_regressor=rng.rand(J + 2, V) / V,
             weights=rng.dirichlet(np.ones(J + 2), V),
             f=rng.randint(0, V, (500, 3)),
             hands_componentsl=rng.randn(45, 45),
             hands_componentsr=rng.randn(45, 45),
             hands_meanl=rng.randn(45), hands_meanr=rng.randn(45))
    kw = _body_params(rng)
    for use_pca, flat in ((False, True), (True, False)):
        ref_m = jsb._from_smplx_npz(path, use_pca, flat)
        got_m = tsb._from_smplx_npz(path, use_pca, flat)
        for name in ref_m._fields:
            np.testing.assert_array_equal(getattr(got_m, name).numpy(),
                                          np.asarray(getattr(ref_m, name)))
        ref = jsb.body_forward(ref_m, **{k: j(v) for k, v in kw.items()})
        got = tsb.body_forward(got_m, **{k: t(v) for k, v in kw.items()})
        close(got.vertices, ref.vertices, M_TOL)


# ------------------------------------------------------------ process_object
def test_prepare_templates_match_jax():
    for is_right in (True, False):
        ref = jpo.prepare_mano_template(3, jmano.load_mano(is_right),
                                        is_right)
        got = tpo.prepare_mano_template(3, tmano.load_mano(is_right),
                                        is_right)
        for g, r in zip(got, ref):
            close(g, r, M_TOL, scale=False)
    idx = np.asarray([0, 4, 9])
    ref = jpo.prepare_object_template(3, jobj.build_object_tensors(), j(idx))
    got = tpo.prepare_object_template(3, tobj.build_object_tensors(), t(idx))
    for g, r in zip(got, ref):
        close(g, r, M_TOL, scale=False)


def test_prepare_interfield_matches_jax():
    rng = np.random.RandomState(8)
    v_h, v_o, v_len = _hand_object(rng)
    v_l = (v_h[:, ::-1] + 0.02).astype(np.float32).copy()
    targets = {"object.v.cam": v_o, "object.v_len": v_len,
               "mano.v3d.cam.r": v_h, "mano.v3d.cam.l": v_l}
    ref = jpo.prepare_interfield(JXDict({k: j(v) for k, v in
                                         targets.items()}))
    got = tpo.prepare_interfield(XDict({k: t(v) for k, v in
                                        targets.items()}))
    assert set(got) == set(ref)
    for k in ("dist.ro", "dist.lo", "dist.or", "dist.ol"):
        close(got[k], ref[k], 1e-4, scale=False)
        d = np.asarray(ref[k])
        # indices where the field is not clamped and the match is clear
        inner = d < tpo.DIST_MAX - 1e-4
        np.testing.assert_array_equal(
            got[k.replace("dist", "idx")].numpy()[inner][:50],
            np.asarray(ref[k.replace("dist", "idx")])[inner][:50])


# ------------------------------------------------------------ metrics_object
@functools.lru_cache(maxsize=1)
def _metric_inputs(T=12, seed=9):
    """A pred/target pair over T frames of one object with hands near it,
    validity gaps included."""
    rng = np.random.RandomState(seed)
    tensors = jobj.build_object_tensors()
    o = 3
    Vm = np.asarray(tensors.v).shape[1]
    v_o = np.repeat(np.asarray(tensors.v)[o:o + 1] / 1000.0, T, 0)
    v_o = (v_o + np.cumsum(rng.randn(T, 1, 3) * 0.002, 0)).astype(np.float32)
    mask = np.repeat(np.asarray(tensors.mask)[o:o + 1], T, 0)
    parts = np.repeat(np.asarray(tensors.parts_ids)[o:o + 1], T, 0)
    diam = np.full(T, np.asarray(tensors.diameter)[o] / 1000.0, np.float32)

    def hand(shift):
        base = v_o[:, :778] + shift
        return (base + rng.randn(*base.shape) * 0.002).astype(np.float32)

    targets = {"object.v.cam": v_o, "mano.v3d.cam.r": hand(0.001),
               "mano.v3d.cam.l": hand(-0.003),
               "object.radian": rng.rand(T).astype(np.float32),
               "is_valid": np.ones(T, np.float32),
               "right_valid": np.ones(T, np.float32),
               "left_valid": np.ones(T, np.float32)}
    targets["is_valid"][5] = 0
    targets["left_valid"][8] = 0
    for s in ("r", "l"):
        targets[f"mano.j3d.cam.{s}"] = targets[f"mano.v3d.cam.{s}"][:, :21]
    pred = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.003)
            for k, v in targets.items() if ".cam." in k or k.endswith("cam")}
    pred["object.radian"] = targets["object.radian"] + 0.1
    fields = jpo.prepare_interfield(JXDict(
        {"object.v.cam": j(v_o), "object.v_len": j(np.full(T, Vm)),
         "mano.v3d.cam.r": j(targets["mano.v3d.cam.r"]),
         "mano.v3d.cam.l": j(targets["mano.v3d.cam.l"])}))
    for k, v in fields.items():
        if k.startswith(("dist.", "idx.")):
            targets[k] = np.asarray(v)
            if k.startswith("dist."):
                pred[k] = np.asarray(v) + rng.rand(*v.shape).astype(
                    np.float32) * 1e-3
    meta = {"object.v.mask": mask.astype(np.float32), "part_ids": parts,
            "diameter": diam}
    return pred, targets, meta


@pytest.mark.parametrize("name", sorted(jmo.object_eval_fn_dict))
def test_object_metrics_match_jax(name):
    pred, targets, meta = _metric_inputs()
    conv = lambda d, c: {k: c(v) for k, v in d.items()}  # noqa: E731
    ref = jmo.object_eval_fn_dict[name](conv(pred, j), conv(targets, j),
                                        conv(meta, j))
    got = tmo.object_eval_fn_dict[name](conv(pred, t), conv(targets, t),
                                        conv(meta, t))
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert np.isfinite(r).any(), k
        close(got[k], r, REL)


def test_v2v_and_accel_match_jax():
    pred, targets, meta = _metric_inputs()
    a, b = targets["object.v.cam"], pred["object.v.cam"]
    close(tmo.compute_v2v_dist(t(a), t(b), t(meta["object.v.mask"]),
                               t(targets["is_valid"])),
          jmo.compute_v2v_dist(j(a), j(b), j(meta["object.v.mask"]),
                               j(targets["is_valid"])), REL)
    close(tmo.compute_error_accel(t(a[:, :50]), t(b[:, :50])),
          jmo.compute_error_accel(j(a[:, :50]), j(b[:, :50])), REL)


def _contact_sequence(T=60, seed=10):
    """A hand resting on an object for frames 5-29 (a window), sliding over
    it for 35-54 (filtered out), and in contact again from 50 to the last
    frame (dropped): distances and matches per MANO vertex."""
    rng = np.random.RandomState(seed)
    vo = (rng.randn(400, 3) * 0.05).astype(np.float32)
    vo[8] = vo[7] + 5e-4  # neighbours: matches that alternate stay a window
    vo[4] = vo[5] + 5e-4
    dist = np.full((T, 778), 0.05, np.float32)
    idx = np.zeros((T, 778), np.int64)
    dist[5:30, 3] = 1e-3
    idx[5:30, 3] = 7
    idx[12:14, 3] = 8  # a tie-free mode of 7
    dist[35:55, 9] = 1e-3
    idx[35:55, 9] = np.arange(20) * 17  # slides far across the surface
    dist[50:, 11] = 1e-3
    idx[50:, 11] = 3
    dist[20:40, 20] = 2e-3
    idx[20:40, 20] = 5
    idx[25:30, 20] = 4  # 5 frames of 4, 15 of 5
    v_hand = np.cumsum(rng.randn(T, 778, 3) * 1e-3, 0).astype(np.float32)
    v_obj = np.cumsum(rng.randn(T, 400, 3) * 1e-3, 0).astype(np.float32)
    valid = np.ones(T)
    valid[10] = 0
    return dist, idx, vo, v_hand, v_obj, valid


def test_contact_windows_and_mdev_match_jax():
    dist, idx, vo, v_hand, v_obj, valid = _contact_sequence()
    ref = jmo.find_contact_windows(dist, idx, vo)
    got = tmo.find_contact_windows(dist, idx, vo)
    np.testing.assert_array_equal(got, ref)
    assert [list(w) for w in got] == [[5, 29, 3, 7], [20, 39, 20, 5]]
    for fv in (None, valid):
        np.testing.assert_array_equal(
            tmo.compute_mdev_windows(got, v_hand, v_obj, fv),
            jmo.compute_mdev_windows(ref, v_hand, v_obj, fv))
        assert tmo.compute_mdev(v_hand, v_obj, got, fv) == \
            jmo.compute_mdev(v_hand, v_obj, ref, fv)
    assert np.isnan(tmo.compute_mdev(v_hand, v_obj, got[:0]))
    assert tmo.eval_motion_deviation(
        t(v_hand), t(v_obj), t(dist), t(idx), t(vo), frame_valid=valid) == \
        jmo.eval_motion_deviation(v_hand, v_obj, dist, idx, vo,
                                  frame_valid=valid)
