"""Port parity of the fused attention (``hands_tpu_torch.ops.attention``):
the plain twin of ``mha_fused`` against the JAX package's Pallas kernel in
interpret mode and its XLA composition ``mha_reference``, and
``ViTBackbone(fused_attn=True)`` against the Flax backbone.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against this twin. Tolerance in f32: atol 2e-5, the JAX test's own bound
(the two frameworks sum the products in another order). In bf16 the twin
rounds the probabilities to bf16 as the kernel does, and the output to bf16:
one bf16 ulp of an output below 4 in magnitude, 2^-6, covers a flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hands_tpu.ops.attention_pallas as jap
from hands_tpu.models.backbones.vit import ViTBackbone as JaxViT
from hands_tpu_torch.models.backbones.vit import ViTBackbone
from hands_tpu_torch.ops import attention as tat


def _qkv(B, N, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, H, D).astype(np.float32) for _ in range(3)]


# (2, 192, 4, 80): HaMeR's 192 tokens and head dim 80
@pytest.mark.parametrize("B,N,H,D", [(2, 192, 4, 80), (1, 64, 2, 64),
                                     (2, 24, 2, 80)])
def test_mha_twin_matches_pallas_interpret_and_reference_f32(B, N, H, D):
    q, k, v = _qkv(B, N, H, D)
    scale = D**-0.5
    got = tat.mha_fused(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert got.shape == (B, N, H, D) and got.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jap.mha_fused(jq, jk, jv, scale,
                                              interpret=True)), atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jap.mha_reference(jq, jk, jv, scale)),
        atol=2e-5)


def test_mha_twin_matches_pallas_interpret_bf16():
    B, N, H, D = 2, 24, 2, 80
    q, k, v = _qkv(B, N, H, D, seed=1)
    scale = D**-0.5
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = tat.mha_fused(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    ref = jap.mha_fused(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                        scale, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2.0**-6)


def test_mha_reads_the_slices_of_a_fused_qkv_in_place():
    """The wrapper takes the (B, N, H, D) views of a (B, N, 3, H, D) tensor;
    on the CPU that is the twin, and no launch is counted."""
    B, N, H, D = 2, 16, 2, 64
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(B, N, 3, H, D).astype(np.float32))
    before = dict(tat.launches)
    got = tat.mha_fused(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], D**-0.5)
    assert tat.launches == before
    want = tat.mha_plain(*(qkv[:, :, i].contiguous() for i in range(3)),
                         D**-0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("static", [False, True])
def test_qkv_attention_twin_against_a_float64_softmax(static):
    """The int8 blocks' attention on a fused bf16 qkv: against softmax(q k^T
    D^-0.5) v in f64 on the same bf16 inputs, within bf16 resolution of the
    output (2^-7 relative to max(|ref|, 1); the static form within one int8
    step)."""
    B, N, H, D = 2, 24, 2, 80
    C = H * D
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(B, N, 3 * C).astype(np.float32)).to(
        torch.bfloat16)
    t = qkv.double().view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    p = torch.softmax(t[0] @ t[1].transpose(-1, -2) * D**-0.5, dim=-1)
    ref = (p @ t[2]).permute(0, 2, 1, 3).reshape(B, N, C)
    if static:
        inv = torch.from_numpy(rng.uniform(20, 150, C).astype(np.float32))
        got = tat.qkv_attention(qkv, H, inv)
        assert got.dtype == torch.int8
        want = torch.clamp(ref * inv, -127, 127)  # some channels clip
        assert float((got.double() - want).abs().max()) <= 1.0
        assert int((got.abs() == 127).sum()) > 0
    else:
        got = tat.qkv_attention(qkv, H)
        assert got.dtype == torch.bfloat16
        err = (got.double() - ref).abs() / ref.abs().clamp(min=1.0)
        assert float(err.max()) <= 2.0**-7


def test_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tat.mha_fused(q, q, q, 1.0)
    with pytest.raises(ValueError):
        tat.qkv_attention(torch.zeros(1, 4, 48, device="meta"), 2)
    with pytest.raises(ValueError):  # transposed heads: not adjacent
        tat._strides(torch.zeros(1, 2, 4, 8).permute(0, 2, 1, 3), 1, 4, 2, 8)


def test_vit_fused_attn_flag_matches_flax_backbone():
    """``ViTBackbone(fused_attn=True)`` (tiny, f32) against the Flax backbone
    with the same flag, its Pallas kernel in interpret mode: 5e-5, the JAX
    test's bound for the flag."""
    from test_torch_calibration import backbone_state_dict

    x = np.random.RandomState(1).rand(1, 256, 192, 3).astype(np.float32)
    fp = JaxViT(variant="tiny", fused_attn=True)
    params = JaxViT(variant="tiny").init(jax.random.PRNGKey(0),
                                         jnp.asarray(x))["params"]
    orig = jap.mha_fused
    jap.mha_fused = lambda q, k, v, scale: orig(q, k, v, scale,
                                                interpret=True)
    try:
        ref = np.asarray(fp.apply({"params": params}, jnp.asarray(x)))
    finally:
        jap.mha_fused = orig
    port = ViTBackbone("tiny", fused_attn=True)
    port.load_state_dict(backbone_state_dict(params, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)
