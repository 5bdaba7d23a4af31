"""Port parity of the static int8 calibration (``hands_tpu_torch.ops.
calibration``, ``hands_tpu_torch.cli.calibrate``): the running activation
maxima of the tiny ViT backbone against the JAX package's ``quant_stats``
collection, the conversion to scales, their injection, and the scale file,
which either package writes and the other reads.

Tolerances: amax arrays 1e-5 relative in f32 (the same reductions on
activations that agree to f32 resolution); in bf16 the two frameworks round
a few activations the other way, and XLA:CPU skips the intermediate bf16
roundings of the GELU chain in this uncompiled-by-hand apply, so 3e-2
relative to max(|ref|, 1), the bound of the bf16 block (observed 1.9e-2 at
the GELU output, below 1.1e-2 elsewhere). Scales 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.cli import calibrate as jcli
from hands_tpu.models.backbones.vit import ViTBackbone as JaxViT
from hands_tpu.ops import calibration as jcal
from hands_tpu_torch.cli import calibrate as tcli
from hands_tpu_torch.models.backbones.vit import ViTBackbone
from hands_tpu_torch.ops import calibration as tcal

POINTS = ("qkv", "proj", "mlp1", "mlp2")


def backbone_state_dict(params, port):
    """Flax ``ViTBackbone`` params (scanned blocks) -> the port backbone's
    ``state_dict``."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {
        "patch_embed.weight": t(np.asarray(
            params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "patch_bias": t(params["patch_embed"]["bias"]),
        "pos_embed": t(params["pos_embed"]),
        "last_norm.scale": t(params["last_norm"]["scale"]),
        "last_norm.bias": t(params["last_norm"]["bias"]),
    }
    blk = params["blocks"]["block"]
    for i in range(len(port.blocks)):
        pre = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.scale"] = t(blk[n]["scale"][i])
            sd[f"{pre}.{n}.bias"] = t(blk[n]["bias"][i])
        for name, node in (("attn.qkv", blk["attn"]["qkv"]),
                           ("attn.proj", blk["attn"]["proj"]),
                           ("mlp.fc1", blk["mlp"]["Dense_0"]),
                           ("mlp.fc2", blk["mlp"]["Dense_1"])):
            sd[f"{pre}.{name}.weight"] = t(np.asarray(node["kernel"][i]).T)
            sd[f"{pre}.{name}.bias"] = t(node["bias"][i])
        for p in POINTS:
            if f"act_scale_{p}" in blk:
                sd[f"{pre}.act_scale_{p}"] = t(blk[f"act_scale_{p}"][i])
    return sd


@pytest.fixture(scope="module")
def tiny():
    """Images and perturbed tiny-backbone params (LayerNorm scale and every
    bias off their init)."""
    rng = np.random.RandomState(0)
    img = rng.rand(2, 256, 192, 3).astype(np.float32)
    params = JaxViT(variant="tiny").init(jax.random.PRNGKey(0),
                                         jnp.asarray(img))["params"]
    noise = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + noise.randn(*p.shape).astype(np.float32)
        * 0.02, params)
    return img, params


def _jax_amax(params, batches, dtype):
    cal = JaxViT(variant="tiny", dtype=dtype, quant_calibrate=True)
    amax = None
    for b in batches:
        _, mutated = cal.apply({"params": params}, jnp.asarray(b),
                               mutable=["quant_stats"])
        amax = jcal.merge_amax(amax, jcal.extract_amax(
            mutated["quant_stats"], backbone_path=()))
    return {k: np.asarray(v) for k, v in amax.items()}


def _port_amax(params, batches, dtype):
    port = ViTBackbone("tiny", dtype=dtype, quant_calibrate=True)
    port.load_state_dict(backbone_state_dict(params, port))
    amax = None
    with torch.no_grad():
        for b in batches:
            tcal.reset_amax(port)
            port(torch.from_numpy(b))
            amax = tcal.merge_amax(amax, tcal.extract_amax(port))
    return amax


def test_amax_matches_jax_extract_amax_f32(tiny):
    img, params = tiny
    batches = [img, img * 3.0]
    ref = _jax_amax(params, batches, jnp.float32)
    got = _port_amax(params, batches, torch.float32)
    assert set(got) == set(POINTS)
    for p, ch in zip(POINTS, (128, 128, 128, 256)):
        assert got[p].shape == (2, ch) and got[p].dtype == torch.float32
        np.testing.assert_allclose(got[p].numpy(), ref[p], rtol=1e-5,
                                   atol=1e-7)
    # the running maximum: a second, larger batch can only raise it
    one = _port_amax(params, batches[:1], torch.float32)
    assert all(bool((got[p] >= one[p]).all()) for p in POINTS)
    assert bool((got["mlp2"] > one["mlp2"]).any())


def test_amax_matches_jax_extract_amax_bf16(tiny):
    img, params = tiny
    ref = _jax_amax(params, [img], jnp.bfloat16)
    got = _port_amax(params, [img], torch.bfloat16)
    for p in POINTS:
        err = np.abs(got[p].numpy() - ref[p]) / np.maximum(np.abs(ref[p]), 1)
        assert err.max() <= 3e-2, (p, err.max())


@pytest.mark.parametrize("margin", [1.0, 1.25])
def test_amax_to_scales_matches_jax(margin):
    rng = np.random.RandomState(2)
    amax = {p: np.abs(rng.randn(2, 16)).astype(np.float32) for p in POINTS}
    amax["proj"][0, :3] = 0.0  # dead channels fall back to eps
    ref = jcal.amax_to_scales({k: jnp.asarray(v) for k, v in amax.items()},
                              margin=margin)
    got = tcal.amax_to_scales({k: torch.from_numpy(v)
                               for k, v in amax.items()}, margin=margin)
    for p in POINTS:
        np.testing.assert_allclose(got[p].numpy(), np.asarray(ref[p]),
                                   rtol=1e-6, atol=0)
        assert bool((got[p] > 0).all())


def test_inject_scales_fills_the_slots_as_jax_does(tiny):
    img, params = tiny
    rng = np.random.RandomState(3)
    scales = {p: rng.uniform(0.01, 0.1, (2, ch)).astype(np.float32)
              for p, ch in zip(POINTS, (128, 128, 128, 256))}
    serve = JaxViT(variant="tiny", dtype=jnp.bfloat16, quant_static=True)
    slots = serve.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]
    injected = jcal.inject_scales(
        slots, {k: jnp.asarray(v) for k, v in scales.items()},
        backbone_path=())
    port = ViTBackbone("tiny", dtype=torch.bfloat16, quant_static=True)
    assert float(port.blocks[0].act_scale_qkv.detach().min()) == 1.0
    tcal.inject_scales(port, {k: torch.from_numpy(v)
                              for k, v in scales.items()})
    want = backbone_state_dict(injected, port)
    for i in range(2):
        for p in POINTS:
            key = f"blocks.{i}.act_scale_{p}"
            torch.testing.assert_close(port.state_dict()[key], want[key],
                                       rtol=0, atol=0)
    with pytest.raises(ValueError):  # wrong depth
        tcal.inject_scales(port, {k: torch.from_numpy(v[:1])
                                  for k, v in scales.items()})
    plain = ViTBackbone("tiny", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # no maxima without quant_calibrate
        tcal.extract_amax(plain)


def test_scale_file_round_trips_between_the_packages(tmp_path):
    rng = np.random.RandomState(4)
    scales = {p: rng.uniform(0.01, 0.1, (2, ch)).astype(np.float32)
              for p, ch in zip(POINTS, (128, 128, 128, 256))}
    by_port, by_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    tcli.save_scales_npz(str(by_port),
                         {k: torch.from_numpy(v) for k, v in scales.items()})
    jcli.save_scales_npz(str(by_jax),
                         {k: jnp.asarray(v) for k, v in scales.items()})
    in_jax = jcli.load_scales_npz(str(by_port))
    in_port = tcli.load_scales_npz(str(by_jax))
    for p in POINTS:
        np.testing.assert_array_equal(np.asarray(in_jax[p]), scales[p])
        np.testing.assert_array_equal(in_port[p].numpy(), scales[p])
        assert in_port[p].dtype == torch.float32


def test_cli_calibrate_writes_scales_on_the_cpu(tmp_path):
    """``python -m hands_tpu_torch.cli.calibrate`` end to end at the tiny
    size: synthetic records, calibration forward, the npz."""
    out = tmp_path / "scales.npz"
    rc = tcli.main(["--vit_variant", "tiny", "--batches", "2",
                    "--batch_size", "2", "--device", "cpu", "-o", str(out)])
    assert rc == 0
    scales = tcli.load_scales_npz(str(out))
    for p, ch in zip(POINTS, (128, 128, 128, 256)):
        assert scales[p].shape == (2, ch)
        assert bool(torch.isfinite(scales[p]).all() and (scales[p] > 0).all())
