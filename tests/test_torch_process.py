"""Port parity of ``train/process.py``: ``process_data_light`` on one
synthetic batch, every target key against the JAX package's. Tolerance 1e-5
(metres for the 3D keys, units of the weak-perspective camera otherwise; two
f32 MANO passes)."""

import numpy as np
import torch

from test_torch_train_util import both
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch
from hands_tpu.ops import mano as jmano
from hands_tpu.train.process import process_data_light as jax_process
from hands_tpu_torch.ops import mano as tmano
from hands_tpu_torch.train.process import process_data_light

NEW_KEYS = [f"mano.{k}.{s}" for s in "rl" for k in
            ("joints3d", "vertices", "v3d.cam", "j3d.cam", "cam_t",
             "cam_t.wp")]


def test_process_data_light_matches_jax():
    cfg = jax_config("hands_light", img_res=64, img_res_ds=64)
    jb, tb = both(make_batch(cfg, 3, seed=2, np_arrays=True))
    _, ref, _ = jax_process(jmano.load_mano(True), jmano.load_mano(False),
                            *jb, cfg.img_res)
    tin, ttg, tmeta = tb
    for v in ttg.values():
        v.requires_grad_(v.is_floating_point())
    inputs, got, meta = process_data_light(
        tmano.load_mano(True), tmano.load_mano(False), tin, ttg, tmeta,
        cfg.img_res)
    assert inputs is tin and meta is tmeta
    assert list(got.keys()) == list(ref.keys())
    assert set(NEW_KEYS) == set(got) - set(ttg)
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].detach().numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=k)
    # GT processing carries no gradient, and the caller's dict is untouched
    assert not any(got[k].requires_grad for k in NEW_KEYS)
    assert "mano.j3d.cam.r" not in ttg
    assert got["mano.vertices.l"].shape == (3, 778, 3)
    assert torch.equal(got["mano.j3d.cam.r"], ttg["mano.j3d.full.r"])
