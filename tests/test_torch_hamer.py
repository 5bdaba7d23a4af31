"""Port parity of the slice: HaMeR (``hamer_light``) serving, tiny ViT
(depth 2, C 128, 2 heads), B = 2, weights carried from the JAX model by
``hands_tpu_torch.utils.from_jax``.

Inputs are demo records built in numpy, preprocessed once by the JAX
pipeline and fed to both models (the preprocessing itself is held by
test_torch_preprocess.py); one test also runs the port's whole ``serve``.

Tolerances on every ``pred.mano.*`` output, relative to max(|ref|, 1):
- f32 path (``compute_dtype="float32"``, which turns the fused block off):
  1e-4;
- bf16 path: the port with ``fused_block=True`` (the block twin on the CPU)
  against JAX with ``fused_block=False`` (the XLA block, which the JAX
  tests pin bit-equal to the kernel's math): 2e-2.
Observed maxima on the CPU: 7.5e-6 (f32) and 4.9e-3 (bf16).

The int8 and fast-GELU configurations (``quant_int8``, ``quant_int8_static``
with calibrated scales carried through ``from_jax``, ``fast_gelu``): the JAX
model is compiled as one program with ``xla_allow_excess_precision=False``
and runs its Pallas block kernels in interpret mode, so both sides keep every
bf16 rounding point; the port runs the kernels' twins. Vertices and joints
(``VERTEX_KEYS``) are held to the same 2e-2 (observed 7.6e-3 dynamic, 8.8e-3
static, 3.5e-3 fast GELU). All outputs: 2e-2 with ``fast_gelu`` (observed
5.4e-3) and 5e-2 in the int8 configurations (observed 1.1e-2 dynamic and
3.7e-2 static, both in ``mano.pose``): the blocks alone agree bit for bit
(test_torch_int8.py), but the bf16 patch embedding ahead of them is summed in
another order, and one bf16 ulp at a block's input moves int8 steps (1/127 of
a channel's range each) that a bf16 block would absorb.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.cli import calibrate as jax_calibrate
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.cli import calibrate as port_calibrate
from hands_tpu_torch.cli.demo import (make_record, pad_to_common_size, serve,
                                      serving_config)
from hands_tpu_torch.models.hamer_light import HamerLightModel
from hands_tpu_torch.ops import vit_block
from hands_tpu_torch.utils.from_jax import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs six workers side by side, and eight threads
    each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _records():
    rng = np.random.RandomState(0)
    recs = []
    for i, ((h, w), rb) in enumerate([((240, 320), [40.3, 50.6, 200.2, 210.7]),
                                      ((300, 260), None)]):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        recs.append(make_record(
            f"img{i}.png", img,
            None if rb is None else np.asarray(rb, np.float32),
            np.asarray([10.2, 20.7, 120.4, 150.1], np.float32),
            focal=None if i == 0 else 900.0))
    pad_to_common_size(recs)
    return recs


@pytest.fixture(scope="module")
def jax_side():
    """JAX inputs (from the JAX pipeline) and perturbed tiny-HaMeR weights:
    every LayerNorm scale and every bias moved off its init."""
    recs = _records()
    cfg = serving_config("hamer_light", "float32", False)
    inputs, _, meta = JaxPre(cfg, is_train=False)(jax_stack(recs),
                                                  jax.random.PRNGKey(0))
    model = JaxHamer(cfg, vit_variant="tiny")
    variables = model.init(jax.random.PRNGKey(0), inputs, meta)
    rng = np.random.RandomState(1)

    def perturb(path, p):
        p = np.asarray(p)
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['scale']") or leaf.endswith("['bias']"):
            p = p + rng.randn(*p.shape).astype(np.float32) * 0.05
        return p

    variables = {"params": jax.tree_util.tree_map_with_path(
        perturb, variables["params"])}
    return recs, inputs, meta, variables


def _np(v):
    return np.array(v, np.float32)  # a writable copy


def _run_pair(jax_side, dtype, fused):
    recs, inputs, meta, variables = jax_side
    jcfg = serving_config("hamer_light", dtype, False)
    ref = JaxHamer(jcfg, vit_variant="tiny")(variables, inputs, meta)
    tcfg = serving_config("hamer_light", dtype, fused)
    model = HamerLightModel(tcfg, vit_variant="tiny")
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(_np(v)) for k, v in inputs.items()}
    tmeta = {"intrinsics": torch.from_numpy(_np(meta["intrinsics"]))}
    with torch.no_grad():
        got = model(tin, tmeta)
    return ref, got


def _max_rel(ref, got, keys=None):
    assert set(ref) == set(got)
    worst = 0.0
    for k in keys or ref:
        a, b = _np(ref[k]), got[k].numpy()
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(a), 1.0))))
    return worst


def test_hamer_f32_matches_jax(jax_side):
    ref, got = _run_pair(jax_side, "float32", fused=True)
    assert got["mano.vertices.r"].shape == (2, 778, 3)
    assert got["mano.joints3d.l"].shape == (2, 21, 3)
    assert _max_rel(ref, got) <= 1e-4


def test_hamer_bf16_fused_block_matches_jax(jax_side):
    before = dict(vit_block.launches)
    ref, got = _run_pair(jax_side, "bfloat16", fused=True)
    assert vit_block.launches == before  # CPU: the twin ran, no kernel
    assert _max_rel(ref, got) <= 2e-2


def test_serve_matches_jax_pipeline_and_model(jax_side):
    """The port's whole serving flow (records -> port preprocessing -> port
    model) against the JAX pipeline and model, f32."""
    recs, inputs, meta, variables = jax_side
    ref = JaxHamer(serving_config("hamer_light", "float32", False),
                   vit_variant="tiny")(variables, inputs, meta)
    cfg = serving_config("hamer_light", "float32", False)
    model = HamerLightModel(cfg, vit_variant="tiny")
    model.load_state_dict(state_dict_from_jax(variables, model))
    out = serve(recs, cfg, model, "cpu")
    got = {k[len("pred."):]: v for k, v in out.items()
           if k.startswith("pred.")}
    assert _max_rel(ref, got) <= 1e-4


def test_from_jax_consumes_every_leaf(jax_side):
    _, _, _, variables = jax_side
    model = HamerLightModel(serving_config(), vit_variant="tiny")
    extra = {"params": dict(variables["params"], stray={"kernel": np.ones(2)})}
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_jax(extra, model)
    sd = state_dict_from_jax(variables, model)
    assert set(sd) == set(model.state_dict())


# ------------------------------------- int8 and fast-GELU configurations
NO_EXCESS = {"xla_allow_excess_precision": False}
VERTEX_KEYS = [f"mano.{k}.{side}" for side in "rl"
               for k in ("vertices", "joints3d", "v3d.cam", "j3d.cam")]
_PALLAS_BLOCKS = ("vit_block_fused_int8", "vit_block_fused_int8_static")


def _jax_forward(cfg, variables, inputs, meta):
    """The JAX model as one compiled program that keeps its bf16 roundings,
    with the Pallas int8 block kernels in interpret mode (nothing in the JAX
    package changes: the test swaps the two entry points while it traces)."""
    model = JaxHamer(cfg, vit_variant="tiny")
    originals = {name: getattr(jvb, name) for name in _PALLAS_BLOCKS}

    def interpreted(fn):
        return lambda *a, **kw: fn(*a, interpret=True, **kw)

    args = (variables, dict(inputs), {"intrinsics": meta["intrinsics"]})
    for name, fn in originals.items():
        setattr(jvb, name, interpreted(fn))
    try:
        fn = jax.jit(lambda v, i, m: dict(model(v, i, m)))
        return fn.lower(*args).compile(NO_EXCESS)(*args)
    finally:
        for name, fn in originals.items():
            setattr(jvb, name, fn)


def _port_forward(cfg, variables, inputs, meta):
    model = HamerLightModel(cfg, vit_variant="tiny")
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(_np(v)) for k, v in inputs.items()}
    tmeta = {"intrinsics": torch.from_numpy(_np(meta["intrinsics"]))}
    before = dict(vit_block.launches)
    with torch.no_grad():
        got = model(tin, tmeta)
    assert vit_block.launches == before  # CPU: twins only
    return model, got


def test_hamer_int8_dynamic_matches_jax(jax_side):
    _, inputs, meta, variables = jax_side
    cfg = serving_config("hamer_light", "bfloat16", quant_int8=True)
    assert cfg.fused_block and cfg.quant_int8  # implied by default_config
    ref = _jax_forward(cfg, variables, inputs, meta)
    model, got = _port_forward(cfg, variables, inputs, meta)
    blk = model.net.backbone.blocks[0]
    assert blk.fused and blk.attn.qkv.weight.dtype == torch.float32
    assert _max_rel(ref, got, VERTEX_KEYS) <= 2e-2
    assert _max_rel(ref, got) <= 5e-2


def test_hamer_int8_static_matches_jax(jax_side):
    """Calibrate on the JAX side, inject, carry weights and scales through
    ``from_jax``, serve the static int8 + fast-GELU configuration on both
    sides. The port's own calibration of the same weights on the same batch
    gives the same scales to bf16 resolution (3e-2 relative, the bound of
    test_torch_calibration.py)."""
    _, inputs, meta, variables = jax_side
    scales = jax_calibrate.calibrate_scales(
        "hamer_light", variables, [(dict(inputs), meta)], vit_variant="tiny")
    params = jax.tree.map(lambda a: a, variables["params"])  # new spine
    blk = dict(params["backbone"]["blocks"]["block"])
    for p, v in scales.items():
        blk[f"act_scale_{p}"] = jnp.asarray(v, jnp.float32)
    params["backbone"] = dict(params["backbone"],
                              blocks={"block": blk})
    static_vars = {"params": params}

    cfg = serving_config("hamer_light", "bfloat16", quant_int8_static=True,
                         fast_gelu=True)
    assert cfg.fused_block and cfg.quant_int8 and cfg.quant_int8_static
    ref = _jax_forward(cfg, static_vars, inputs, meta)
    model, got = _port_forward(cfg, static_vars, inputs, meta)
    np.testing.assert_array_equal(
        model.net.backbone.blocks[1].act_scale_mlp2.detach().numpy(),
        np.asarray(scales["mlp2"])[1])
    assert _max_rel(ref, got, VERTEX_KEYS) <= 2e-2
    assert _max_rel(ref, got) <= 5e-2

    tin = {k: torch.from_numpy(_np(v)) for k, v in inputs.items()}
    own = port_calibrate.calibrate_scales(
        "hamer_light", model.state_dict(), [(tin, None)], vit_variant="tiny",
        device="cpu")
    for p, v in scales.items():
        a = np.asarray(v)
        assert own[p].shape == a.shape
        assert np.max(np.abs(own[p].numpy() - a) / np.abs(a)) <= 3e-2, p


def test_hamer_fast_gelu_matches_jax(jax_side):
    """bf16 with the tanh GELU: the port's fused block (its twin here)
    against the JAX XLA block, as the bf16 test above."""
    _, inputs, meta, variables = jax_side
    ref = _jax_forward(serving_config("hamer_light", "bfloat16", False,
                                      fast_gelu=True),
                       variables, inputs, meta)
    _, got = _port_forward(serving_config("hamer_light", "bfloat16", True,
                                          fast_gelu=True),
                           variables, inputs, meta)
    assert _max_rel(ref, got) <= 2e-2
    _, exact = _port_forward(serving_config("hamer_light", "bfloat16", True),
                             variables, inputs, meta)
    assert not torch.equal(got["mano.vertices.r"], exact["mano.vertices.r"])
