"""Port parity of the ResNet backbones: ``hands_tpu_torch.models.backbones.
resnet`` against ``hands_tpu.models.backbones.resnet``, weights carried
through the rules of ``hands_tpu_torch.utils.from_jax``.

Every leaf is overwritten with a seeded numpy draw on the JAX side, the zero-
initialised last BatchNorm scale of each block and the running statistics
included, so that no branch is silent. Inputs: (2, 64, 64, 3) from the seed
(a 2x2 output map; the 224^2 width runs in test_torch_hands_light.py).

Tolerances, relative to max(|ref|, 1) over the output map:
- f32: 1e-4 (sums of up to 4608 products in another order through 17 or 50
  BatchNorm layers; observed 1.5e-6);
- bf16: the JAX side compiled with ``xla_allow_excess_precision=False`` so
  that it keeps its bf16 roundings; a rounding that falls the other way
  in one of ~50 layers moves a value by a bf16 ulp (2^-8 relative) and is
  carried on, so 5e-2 of the map's largest value (observed 1.1e-2);
- ``quant_int8``: activations are re-quantised per sample in every block, so
  an f32 difference of one ulp ahead of a rounding boundary moves an int8
  step (1/127 of the sample's range): 5e-2 (observed 2e-7 on ResNet-18,
  where no step moved; 3.8e-2 on ResNet-50), with the single convolution
  held bit for bit in test_torch_int8_conv.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.models.backbones import resnet as jres
from hands_tpu_torch.models.backbones import resnet as tres
from hands_tpu_torch.utils import from_jax

NO_EXCESS = {"xla_allow_excess_precision": False}


def fill_variables(shapes, seed):
    """A Flax variable tree of ShapeDtypeStructs -> numpy draws for every
    leaf: lecun-scaled kernels, BatchNorm scales in [0.5, 1.5], biases and
    running means N(0, 0.1), running variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.randn(*shape) / np.sqrt(fan_in)
        elif name.endswith("['scale']") or name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            a = rng.randn(*shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(name, dtype, quant_int8=False, seed=0):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jmodel = getattr(jres, name)(dtype=jdt, quant_int8=quant_int8)
    tmodel = getattr(tres, name)(dtype=tdt, quant_int8=quant_int8).eval()
    x = np.random.RandomState(seed + 1).randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = fill_variables(shapes, seed)
    fn = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))
    ref = fn.lower(variables, jnp.asarray(x)).compile(NO_EXCESS)(
        variables, jnp.asarray(x))

    flat = from_jax._flatten(variables["params"])
    flat.update(from_jax._flatten(variables["batch_stats"], "batch_stats"))
    # the rules name a scope; here the backbone is the whole tree
    flat = {("batch_stats/bb/" + k[len("batch_stats/"):]
             if k.startswith("batch_stats/") else "bb/" + k): v
            for k, v in flat.items()}
    sd = {}
    for port_key, jax_path, fn_, _ in (
            (p, j, f, None) for p, j, f in from_jax._resnet("bb", "m", tmodel)):
        a = flat.pop(jax_path)
        sd[port_key[len("m."):]] = torch.from_numpy(
            np.array(a if fn_ is None else fn_(a), np.float32))
    assert not flat, sorted(flat)
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy(), tmodel


def _max_rel(ref, got):
    assert ref.shape == got.shape and np.isfinite(got).all()
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1.0))


@pytest.mark.parametrize("name,channels", [("resnet18", 512),
                                           ("resnet50", 2048)])
def test_resnet_f32_matches_jax(name, channels):
    ref, got, model = _pair(name, "float32")
    assert got.shape == (2, 2, 2, channels)
    assert model.out_channels == channels
    assert channels == tres.BACKBONE_INFO[name]["n_output_channels"]
    assert float(np.abs(ref).max()) > 0.1  # the map is not silent
    assert _max_rel(ref, got) <= 1e-4


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_bf16_matches_jax(name):
    ref, got, model = _pair(name, "bfloat16")
    assert model.conv_stem.weight.dtype == torch.float32  # cast per call
    assert _max_rel(ref, got) <= 5e-2


def test_resnet_int8_matches_jax():
    ref, got, model = _pair("resnet18", "float32", quant_int8=True)
    from hands_tpu_torch.ops.quant import Int8Conv
    assert isinstance(model.stages[0][0].conv1, Int8Conv)
    assert not isinstance(model.conv_stem, Int8Conv)  # the stem stays f32
    assert _max_rel(ref, got) <= 5e-2
    exact, _, _ = _pair("resnet18", "float32")
    assert _max_rel(exact, got) > 1e-4  # the int8 path really ran


def test_backbone_info_matches_jax():
    assert tres.BACKBONE_INFO == jres.BACKBONE_INFO
