"""Port parity of the visualisation and its entry points against the JAX
package:

- ``render/software.py`` (``render_mesh``, ``overlay_mesh``,
  ``rotate_sideview``), ``utils/vis.visualize_rend_stack`` and
  ``utils/viewer.render_sequence``: bit-equal on the same numpy inputs;
- ``utils/vis.visualize_all`` on a tiny WildHands forward (ResNet-18 at
  160^2, weights carried from JAX by ``utils/from_jax``): the same figure
  names as the JAX module; on one vis dict the data of every panel (the
  render stacks and the keypoint sets drawn) bit-equal to the JAX module's;
  on each package's own forward the keypoints within 1e-2 px. The figures
  are PIL drawings (the card's machine has no matplotlib), so the framing
  is not compared;
- ``Trainer.visualize`` pushes the images; only the drawing may fail;
- ``cli.demo`` writes ``<stem>_<figure>.png`` for the JAX module's figure
  names and honours ``--no_vis``;
- ``cli.sample_data`` (the reprojection errors within 1e-2 px of the JAX
  CLI's) and ``cli.verify_setup`` (the JAX CLI's verdicts) on fixture trees.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from hands_tpu.cli import sample_data as jsample
from hands_tpu.cli import verify_setup as jverify
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch
from hands_tpu.ops import mano as jmano
from hands_tpu.render import software as jsoft
from hands_tpu.train.process import process_data_light as jax_process
from hands_tpu.utils import viewer as jviewer
from hands_tpu.utils import vis as jvis
from hands_tpu_torch.cli import demo as tdemo
from hands_tpu_torch.cli import sample_data as tsample
from hands_tpu_torch.cli import verify_setup as tverify
from hands_tpu_torch.config import default_config
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import mano as tmano
from hands_tpu_torch.render import software as tsoft
from hands_tpu_torch.train.process import process_data_light
from hands_tpu_torch.utils import viewer as tviewer
from hands_tpu_torch.utils import vis as tvis
from test_torch_datasets import build_sample_tree
from test_torch_hands_light import run_pair
from test_torch_train_util import both

PX_TOL = 1e-2
TINY = dict(backbone="resnet18", compute_dtype="float32", use_glb_feat=False,
            use_grasp_loss=False, use_render_seg_loss=False, img_res=160,
            img_res_ds=160)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hand(seed=0, z=0.6):
    """A posed right hand (numpy), its faces and a 112^2 patch camera."""
    model = tmano.load_mano(True)
    rng = np.random.RandomState(seed)
    out = tmano.mano_forward(
        model, torch.zeros(1, 10),
        torch.from_numpy((rng.randn(1, 45) * 0.3).astype(np.float32)),
        torch.from_numpy((rng.randn(1, 3) * 0.5).astype(np.float32)))
    v = out.vertices[0].numpy() + np.float32([0.01, -0.02, z])
    K = np.asarray([[300.0, 0, 56], [0, 300.0, 56], [0, 0, 1]], np.float32)
    return v, model.faces.numpy(), K


def test_renderer_is_bit_equal_to_jax():
    v, f, K = _hand()
    for mod_a, mod_b in ((jsoft, tsoft),):
        img_a, al_a = mod_a.render_mesh(v, f, K, (112, 112))
        img_b, al_b = mod_b.render_mesh(v, f, K, (112, 112))
        np.testing.assert_array_equal(img_b, img_a)
        np.testing.assert_array_equal(al_b, al_a)
        assert al_b.sum() > 100  # the hand covers the patch's centre
        base = np.random.RandomState(1).rand(112, 112, 3).astype(np.float32)
        np.testing.assert_array_equal(
            mod_b.overlay_mesh(base, v, f, K, opacity=0.7),
            mod_a.overlay_mesh(base, v, f, K, opacity=0.7))
        for deg in (90.0, 200.0):
            np.testing.assert_array_equal(mod_b.rotate_sideview(v, deg),
                                          mod_a.rotate_sideview(v, deg))


def test_rend_stack_and_overlay_are_bit_equal_to_jax():
    v, f, K = _hand()
    v2 = v + np.float32([-0.03, 0.0, 0.05])
    img = np.random.RandomState(2).rand(112, 112, 3).astype(np.float32)
    for verts in ([v, v2], []):
        faces = [f] * len(verts)
        np.testing.assert_array_equal(
            tvis.visualize_rend_stack(img, verts, faces, K),
            jvis.visualize_rend_stack(img, verts, faces, K))
    np.testing.assert_array_equal(
        tvis.visualize_mesh_overlay(img, [v, v2], [f, f], K),
        jvis.visualize_mesh_overlay(img, [v, v2], [f, f], K))
    # the labelled keypoint panel and a box outline, drawn with PIL
    kps = tvis.visualize_kps(img, [("GT", np.float32([[20.0, 30.0]]))], "t")
    assert kps.shape == (112 + tvis.TITLE_H, 112, 3) and kps.dtype == np.uint8
    canvas = Image.new("RGB", (112, 112))
    tvis.plot_2d_bbox(ImageDraw.Draw(canvas), [10, 20, 60, 90])
    drawn = np.asarray(canvas)
    assert tuple(drawn[20, 30]) == tvis.BOX_RGB and drawn[50, 30].sum() == 0


def test_viewer_matches_jax(tmp_path):
    v, f, K = _hand()
    T = 3
    images = np.random.RandomState(3).rand(T, 112, 112, 3).astype(np.float32)
    seq = np.stack([v + np.float32([0.01 * t, 0, 0]) for t in range(T)])
    got = tviewer.render_sequence(images, [seq], [f], K, sideview=True)
    ref = jviewer.render_sequence(images, [seq], [f], K, sideview=True)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (T, 112, 224, 3)
    gif = tviewer.save_gif(got, str(tmp_path / "a" / "seq.gif"))
    strip = tviewer.save_strip(got, str(tmp_path / "strip.png"), max_frames=2)
    assert Image.open(gif).n_frames == T
    want = np.concatenate([got[0], got[T - 1]], axis=1)
    np.testing.assert_array_equal(
        np.asarray(Image.open(strip).convert("RGB")),
        (np.clip(want, 0, 1) * 255).astype(np.uint8))


# --------------------------------------------------------------- visualize
@pytest.fixture(scope="module")
def forwards():
    """One synthetic batch of 2 through both packages' GT processing and a
    tiny WildHands forward on the same weights: (JAX vis dict, port vis
    dict, JAX config, port config)."""
    jcfg = jax_config("hands_light", **TINY)
    cfg = default_config("hands_light", **TINY)
    batch = make_batch(jcfg, 2, seed=0, np_arrays=True)
    (ji, jt, jm), (ti, tt, tm) = both(batch)
    ji, jt, jm = jax_process(jmano.load_mano(True), jmano.load_mano(False),
                             ji, jt, jm, jcfg.img_res)
    ti, tt, tm = process_data_light(tmano.load_mano(True),
                                    tmano.load_mano(False), ti, tt, tm,
                                    cfg.img_res)
    ref, got, _, _ = run_pair(TINY, {k: np.asarray(v) for k, v in ji.items()},
                              {k: np.asarray(v) for k, v in jm.items()})
    jvis_dict, tvis_dict = {}, XDict()
    for prefix, jd, td in (("inputs.", ji, ti), ("pred.", ref, got),
                           ("targets.", jt, tt), ("meta_info.", jm, tm)):
        jvis_dict.update({prefix + k: np.asarray(v) for k, v in jd.items()})
        tvis_dict.merge(XDict(td).prefix(prefix))
    return jvis_dict, tvis_dict, jcfg, cfg


def _faces():
    return {"r": jmano.load_mano(True).faces,
            "l": jmano.load_mano(False).faces}


def test_visualize_all_names_and_panels_match_jax(forwards):
    jd, td, jcfg, cfg = forwards
    ref = jvis.visualize_all(jd, jcfg, max_examples=1)
    got = tvis.visualize_all(td, cfg, max_examples=1)
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert "0__targets_kps" in dict(got) and "0__pred_kps" in dict(got)
    for _, img in got:
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    grid = dict(got)["0__pred_kps"]
    assert abs(grid.shape[0] - grid.shape[1]) < grid.shape[0] * 0.2

    # the data of each panel from one dict, against the JAX module's
    faces = {k: np.asarray(v) for k, v in _faces().items()}
    ex = tvis.example_panels(jd, cfg, 0, faces)
    img = jvis.denormalize_image(jd["inputs.img"][0], jcfg.img_norm_mean,
                                 jcfg.img_norm_std)
    np.testing.assert_array_equal(ex["img"], img)
    K = jd["meta_info.intrinsics"][0]
    for flag in ("targets", "pred"):
        want = [(jd[f"{flag}.mano.j2d.norm.{s}"][0][:, :2] + 1) * 0.5
                * jcfg.img_res for s in ("r", "l")]
        want += [jvis._project2d(jd[f"{flag}.mano.j3d.cam.{s}"][0], K)
                 for s in ("r", "l")]
        for g, w in zip(ex["kps"][flag], want):
            np.testing.assert_array_equal(g, w)
    for (title, stack), flag in zip(ex["rends"], ("targets", "pred")):
        verts = [jd[f"{flag}.mano.v3d.cam.{s}"][0] for s in ("r", "l")]
        np.testing.assert_array_equal(stack, jvis.visualize_rend_stack(
            img, verts, [faces["r"], faces["l"]], K))
    assert [t for t, _ in ex["rends"]] == ["GT", "pred w/ pred_cam_t"]

    # each package's own forward: the keypoints drawn agree
    ex_t = tvis.example_panels(tvis._host_dict(td), cfg, 0, faces)
    for flag in ("targets", "pred"):
        for g, w in zip(ex_t["kps"][flag], ex["kps"][flag]):
            np.testing.assert_allclose(g, w, rtol=0, atol=PX_TOL)


def test_trainer_visualize_pushes_images(tmp_path):
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train import trainer as trainer_mod
    from hands_tpu_torch.utils.experiment import Experiment

    cfg = default_config("hands_light", **dict(
        TINY, dataset="synthetic", val_dataset="synthetic", logger="none"))
    val = DeviceDataLoader(SyntheticRecordDataset(cfg, "val", 2), cfg, 2,
                           is_train=False, drop_last=False, device="cpu",
                           num_workers=0)
    trainer = trainer_mod.Trainer(cfg, fetch_model(cfg, "cpu"),
                                  Experiment(cfg, root=str(tmp_path)))
    pushed = []
    trainer.exp.push_images = lambda images, step: pushed.append(
        (step, [n for n, _ in images]))
    images = trainer.visualize(None, val, 7)
    assert pushed == [(7, [n for n, _ in images])]
    assert [n for n, _ in images] == [
        "0__targets_kps", "0__pred_kps", "0__rend_rvalid=1, lvalid=1"]
    # a drawing failure is reported and ends nothing ...
    with mock.patch("hands_tpu_torch.utils.vis.visualize_all",
                    side_effect=ValueError("no font")):
        assert trainer.visualize(None, val, 8) == []
    # ... but the GT processing and the forward are not covered
    with mock.patch.object(trainer_mod, "process_data_light",
                           side_effect=RuntimeError("kernel")):
        with pytest.raises(RuntimeError, match="kernel"):
            trainer.visualize(None, val, 9)
    assert len(pushed) == 1


def _demo_images(root, n=2):
    import cv2

    rng = np.random.RandomState(5)
    for i in range(n):
        cv2.imwrite(os.path.join(root, f"im{i}.png"),
                    rng.randint(0, 256, (150 + 20 * i, 170, 3), np.uint8))


def test_demo_writes_the_jax_overlay_set_and_honours_no_vis(tmp_path):
    _demo_images(str(tmp_path))
    over = dict(backbone="resnet18", img_res=160, img_res_ds=160)
    for flag, out in (([], "vis"), (["--no_vis"], "novis")):
        rc = tdemo.run_demo(["--dir", str(tmp_path), "--batch_size", "2",
                             "--device", "cpu", "--out",
                             str(tmp_path / out)] + flag, overrides=over)
        assert rc == 0
    novis = sorted(os.listdir(tmp_path / "novis"))
    assert novis == ["im0_pred.npz", "im1_pred.npz"]
    # the JAX demo's names for the same served batch
    from hands_tpu_torch.data.datasets import _read_image
    from hands_tpu_torch.models.registry import fetch_model

    cfg = tdemo.serving_config("hands_light").replace(**over)
    recs = [tdemo.make_record(str(tmp_path / f"im{i}.png"),
                              _read_image(str(tmp_path / f"im{i}.png"))[0])
            for i in range(2)]
    tdemo.pad_to_common_size(recs)
    out, targets = tdemo.serve_with_targets(
        recs, cfg, fetch_model(cfg, "cpu", seed=0), "cpu")
    vis = dict(out.to_np())
    vis.update({"targets." + k: v for k, v in XDict(targets).to_np().items()})
    want = {f"im{name.split('__')[0]}_{name.replace('/', '_')}.png"
            for name, _ in jvis.visualize_all(vis, cfg, max_examples=2)}
    got = set(os.listdir(tmp_path / "vis")) - set(novis)
    assert got == want and len(got) >= 4, (got, want)


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _errors(text):
    return [float(ln.split("err ")[1].split("px")[0])
            for ln in text.splitlines() if "reprojection err" in ln]


@pytest.mark.parametrize("tree", ["sample", "synthetic"])
def test_sample_data_matches_jax(tmp_path, monkeypatch, capsys, tree):
    if tree == "sample":
        build_sample_tree(str(tmp_path / "data"))
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    argv = []
    with _cwd(tmp_path):
        jsample.main(argv)
        ref = _errors(capsys.readouterr().out)
        got = tsample.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
    assert ("falling back to synthetic" in out) == (tree == "synthetic")
    assert len(got) == len(ref) == len(_errors(out)) > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=PX_TOL)
    for i in range(len(got)):
        assert os.path.getsize(tmp_path / "logs/sample_data" /
                               f"sample_{i}.png") > 0


def test_verify_setup_verdicts_match_jax(tmp_path, monkeypatch):
    """Without smplx, pytorch3d or the MANO/SMPL-X files the three model
    checks SKIP in both; with ``DATA_DIR`` on the miniature trees each
    dataset check gives the JAX CLI's verdict, but ARCTIC's, whose mixed
    image sizes only the port stacks."""
    from test_torch_datasets import build_tree

    names = ["epic", "arctic", "epic_seg"]
    for env in ({}, {"DATA_DIR": str(tmp_path / "data")}):
        for k in ("MANO_DIR", "SMPLX_DIR", "DATA_DIR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if env:
            build_tree(str(tmp_path / "data"))
        ref = {k: s for k, (s, _) in jverify.run_all(
            names, verbose=False).items()}
        got = tverify.run_all(names, verbose=False, device="cpu")
        if env:
            # ARCTIC's tree mixes the egocam's and the fixed views' image
            # sizes in one batch: the JAX stack_records raises, the port
            # pads (ROADMAP, deliberate divergences: mixed batches)
            assert ref["dataset:arctic"] == tverify.FAIL
            ref["dataset:arctic"] = tverify.PASS
        assert {k: s for k, (s, _) in got.items()} == ref
        assert got["mano_fk"][0] == got["rasterizer"][0] == tverify.SKIP
    assert tverify.main(["--datasets", "epic", "--device", "cpu"]) == 0
