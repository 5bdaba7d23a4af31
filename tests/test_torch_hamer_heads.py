"""Port parity of HaMeR with its evaluation heads on: the grasp classifier
and the silhouette render (``use_grasp_loss`` and ``use_render_seg_loss``,
the defaults of ``default_config("hamer_light")``), tiny ViT, B = 2, f32,
weights carried through ``from_jax``.

Tolerances relative to max(|ref|, 1): 1e-4 on ``mano.*`` and ``grasp.*`` (as
test_torch_hamer.py); ``render.*`` 2e-3 against the compiled JAX model and
2e-5 against the JAX render run op by op on the same vertices (compiled,
XLA:CPU fuses the splat's two-term product with other multiply-adds:
test_torch_rasterizer.py).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.ops.rasterizer import render_silhouette as jax_render
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.hamer_light import HamerLightModel
from hands_tpu_torch.ops import rasterizer
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hamer import _max_rel, _np, jax_side  # noqa: F401


def test_hamer_grasp_and_render_match_jax(jax_side):  # noqa: F811
    _, inputs, meta, _ = jax_side
    kw = dict(compute_dtype="float32")
    jcfg = jax_config("hamer_light", **kw)
    assert jcfg.use_grasp_loss and jcfg.use_render_seg_loss
    jmodel = JaxHamer(jcfg, vit_variant="tiny")
    variables = jmodel.init(jax.random.PRNGKey(1), inputs, meta)
    rng = np.random.RandomState(2)
    variables = {"params": jax.tree.map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.02).astype(
            np.float32), variables["params"])}
    ref = jmodel(variables, inputs, meta)

    model = HamerLightModel(default_config("hamer_light", **kw),
                            vit_variant="tiny").eval()
    assert any(k.startswith("net.grasp_classifier") for k in
               model.state_dict())
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(_np(v)) for k, v in inputs.items()}
    tmeta = {"intrinsics": torch.from_numpy(_np(meta["intrinsics"]))}
    with torch.no_grad():
        got = model(tin, tmeta)
    assert got["render.r"].shape == (2, 224, 224)
    assert got["grasp.r"].shape == (2, 9)
    flat = [k for k in ref if not k.startswith("render.")]
    assert _max_rel(ref, got, flat) <= 1e-4
    assert _max_rel(ref, got, ["render.r", "render.l"]) <= 2e-3
    K = jnp.asarray(meta["intrinsics"])
    with jax.disable_jit():
        for side in ("r", "l"):
            v = _np(ref[f"mano.v3d.cam.{side}"])
            want = jax_render(jnp.asarray(v), None, K, 224)
            mine = rasterizer.render_silhouette(
                torch.from_numpy(v), None, tmeta["intrinsics"], 224)
            np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                       atol=2e-5)
