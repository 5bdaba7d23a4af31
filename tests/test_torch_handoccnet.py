"""Port parity of HandOccNet (``hands_tpu_torch.models.handoccnet_light``)
against the JAX package's, on the CPU.

- Modules: ``SpatialGate``, ``GatedAttentionBlock`` with and without the
  injection gate, ``Hourglass`` and ``Regressor``, each against its Flax
  class on the same numpy inputs and weights, f32.
- The whole model's forward as the JAX tests run it: B = 1 and the
  default ``img_res`` 224 with the grasp classifier and the render on
  (``tests/test_model_families.py``), in f32 and in bf16. Every Flax leaf
  is a numpy draw (``test_torch_hands_light.fill_variables``), carried by
  ``utils.from_jax``. The train step is in test_torch_handoccnet_train.py.

Tolerances: f32 outputs 1e-4 of each output's scale (max(|ref|.max(), 1));
bf16 outputs 2e-2 of it, or twice the JAX model's own bf16-to-f32 distance
where that is larger (the JAX side compiled without excess precision).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch as jax_make_batch
from hands_tpu.models import handoccnet_light as jho
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models import handoccnet_light as tho
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.utils import from_jax
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import fill_variables, max_rel

RTOL = 1e-4
BF16_RTOL = 2e-2
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def carry(module, variables, rules):
    """Load a Flax module's variables into the port module by ``rules``
    (``utils.from_jax``'s, for the module itself): every leaf used, every
    port entry filled."""
    flat = from_jax._flatten(variables["params"])
    flat.update(from_jax._flatten(variables.get("batch_stats", {}),
                                  "batch_stats"))
    sd = {}
    for port_key, jax_path, fn in rules:
        a = flat.pop(jax_path)
        sd[port_key] = torch.from_numpy(np.array(fn(a) if fn else a,
                                                 np.float32))
    assert not flat, sorted(flat)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def module_pair(jmod, tmod, rules_fn, *args, seed=1):
    """Fill the Flax module's variables, carry them, run both (eval)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _np(fill_variables(shapes, seed))
    ref = jmod.apply(variables, *args)
    carry(tmod, variables, rules_fn(tmod))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(np.array(a)) for a in args))
    return ref, got


def per_tensor(ref, got):
    a, b = np.asarray(ref, np.float32), got.numpy()
    assert a.shape == b.shape and np.isfinite(b).all()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


def test_spatial_gate_matches_flax():
    x = np.random.RandomState(0).randn(2, 16, 16, 64).astype(np.float32)
    ref, got = module_pair(jho.SpatialGate(), tho.SpatialGate(),
                           lambda m: from_jax._spatial_gate("", ""), x)
    for r, g in zip(ref, got):
        assert per_tensor(r, g) <= RTOL


@pytest.mark.parametrize("injection", [True, False])
def test_gated_attention_block_matches_flax(injection):
    rng = np.random.RandomState(int(injection))
    q = rng.randn(2, 8, 8, 64).astype(np.float32)
    k = rng.randn(2, 8, 8, 64).astype(np.float32)
    kpe = rng.randn(2, 64, 64).astype(np.float32)
    ref, got = module_pair(
        jho.GatedAttentionBlock(injection=injection),
        tho.GatedAttentionBlock(64, injection=injection, size=8),
        lambda m: from_jax._gated_block("", "", m), q, k, kpe)
    assert per_tensor(ref, got) <= RTOL


def test_hourglass_matches_flax():
    x = np.random.RandomState(2).randn(2, 16, 16, 32).astype(np.float32)
    ref, got = module_pair(jho.Hourglass(channels=32),
                           tho.Hourglass(channels=32),
                           lambda m: from_jax._hourglass("", "", m), x)
    assert per_tensor(ref, got) <= RTOL


def test_regressor_matches_flax():
    """The hourglass, the spatial softmax's 2D joints, the encoder, the
    (H, W, C) flatten into the MLP and the 6D rotations."""
    x = np.random.RandomState(3).randn(1, 32, 32, 256).astype(np.float32)
    ref, got = module_pair(jho.Regressor(), tho.Regressor(),
                           lambda m: from_jax._regressor("", "", m), x)
    assert set(ref) == set(got)
    for key in ref:
        assert per_tensor(ref[key], got[key]) <= RTOL, key


# ----------------------------------------------------------- whole model
def _model_pair(dtype, B=1, options=None, **kw):
    ckw = dict(compute_dtype=dtype, **kw)
    jcfg = jax_config("handoccnet_light", **ckw)
    jmodel = jax_fetch_model(jcfg)
    inputs, _, meta = jax_make_batch(jcfg, B, seed=0)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), inputs, meta))
    variables = _np(fill_variables(shapes, 1))
    fn = jax.jit(lambda v, i, m: dict(jmodel(v, i, m)))
    ref = fn.lower(variables, inputs, meta).compile(options)(
        variables, inputs, meta)
    model = fetch_model(default_config("handoccnet_light", **ckw), "cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    tin = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    tmeta = {k: torch.from_numpy(np.array(v)) for k, v in meta.items()}
    with torch.no_grad():
        got = model(tin, tmeta)
    return ref, got


@pytest.fixture(scope="module")
def f32_pair():
    return _model_pair("float32")


def test_forward_matches_jax(f32_pair):
    """The default config (centre + corner KPE, grasp and render on), B = 1
    at 224^2: every prediction key."""
    ref, got = f32_pair
    assert {"grasp.r", "render.l", "mano.v3d.cam.r"} <= set(ref)
    worst, per_key = max_rel(dict(ref), dict(got), per_tensor=True)
    assert worst <= RTOL, per_key


def test_bf16_forward_matches_jax(f32_pair):
    """bf16 compute (the regressor stays f32): each key within 2e-2 of its
    scale, or where the JAX model's own bf16 output lies further from its
    f32 output, within twice that distance (random weights through the
    leaky ResNet-50, FIT and SET; observed 1.07 times at worst, on
    ``mano.pose.l``)."""
    ref, got = _model_pair("bfloat16", options=NO_EXCESS)
    _, port = max_rel(dict(ref), dict(got), per_tensor=True)
    own = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in ref.items()}
    _, jax_own = max_rel(dict(f32_pair[0]), own, per_tensor=True)
    for k, err in port.items():
        assert err <= max(BF16_RTOL, 2.0 * jax_own[k]), (k, err, jax_own[k])
