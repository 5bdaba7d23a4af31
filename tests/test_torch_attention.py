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

import itertools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hands_tpu.ops.attention_pallas as jap
from hands_tpu.models.backbones.vit import ViTBackbone as JaxViT
from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.models.backbones.vit import ViTBackbone
from hands_tpu_torch.ops import attention as tat
from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops import vit_block as tvb
from hands_tpu_torch.ops import vit_block_ablation as tabl
from hands_tpu_torch.ops import vit_block_int8 as t8

NO_EXCESS = {"xla_allow_excess_precision": False}


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


def _flax_block_params(C, seed):
    """A Flax ``Block`` param tree (mlp_ratio 1) of numpy draws."""
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": (rng.randn(i, o) * i**-0.5).astype(np.float32),
                "bias": (rng.randn(o) * 0.1).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
                "bias": (0.1 * rng.randn(C)).astype(np.float32)}

    return {"norm1": ln(), "attn": {"qkv": dense(C, 3 * C),
                                    "proj": dense(C, C)},
            "norm2": ln(), "mlp": {"Dense_0": dense(C, C),
                                   "Dense_1": dense(C, C)}}


def _assert_bf16_close(got, ref):
    err = np.abs(got - ref)
    assert np.max(err / np.maximum(np.abs(ref), 1.0)) <= 3e-2, err.max()
    assert np.mean(err) <= 1e-3, err.mean()


# B = 1; token counts off the kernel's 16-row tiles and the ViT-H count;
# the head dims of the tiny ViT (64) and of ViT-H (80)
@pytest.mark.parametrize("N,D", list(itertools.product((50, 145, 192),
                                                       (64, 80))))
def test_attention_twins_match_the_pallas_blocks_at_ragged_shapes(N, D):
    """``vit_block.attention_plain`` (K3) and ``qkv_attention_plain``
    (dynamic, K5; static, K6) inside their block twins, against the Pallas
    blocks in interpret mode (compiled without excess precision), two heads
    of head dim D, at the bf16 block tolerance (3e-2 relative to max(|ref|,
    1), mean 1e-3)."""
    C = 2 * D
    p = _flax_block_params(C, seed=N + D)
    x = (np.random.RandomState(N).randn(1, N, C) * 0.5).astype(np.float32)
    flat = {k: jnp.asarray(v) for k, v in
            jvb.block_params_from_flax(p).items()}
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    rng = np.random.RandomState(5)
    act = {"qkv": rng.uniform(0.02, 0.05, C), "proj": rng.uniform(
        0.005, 0.02, C), "mlp1": rng.uniform(0.02, 0.05, C),
           "mlp2": rng.uniform(0.005, 0.03, C)}
    act = {k: v.astype(np.float32) for k, v in act.items()}
    p32 = tvb.block_params_from_flax(p, dtype=torch.float32)
    static = quant.fold_static_scales(
        p32, {k: torch.from_numpy(v) for k, v in act.items()})
    cases = [
        (jvb.vit_block_fused, (xb, flat),
         tvb.vit_block_plain(xt, tvb.block_params_from_flax(p), 2)),
        (jvb.vit_block_fused_int8, (xb, flat),
         t8.vit_block_int8_plain(xt, quant.prepare_int8(p32), 2, False)),
        (jvb.vit_block_fused_int8_static,
         (xb, flat, {k: jnp.asarray(v) for k, v in act.items()}),
         t8.vit_block_int8_static_plain(xt, static, 2, False))]
    for kernel, args, got in cases:
        ref = kernel.lower(*args, num_heads=2, fast_gelu=False,
                           interpret=True).compile(NO_EXCESS)(*args)
        _assert_bf16_close(got.float().numpy(), np.asarray(ref, np.float32))


def _meta_calls(N, D, dtype=torch.bfloat16):
    """Each attention wrapper on meta tensors of N tokens, head dim D."""
    H = 2
    C = H * D
    qkv = torch.zeros(1, N, 3 * C, dtype=dtype, device="meta")
    inv = torch.zeros(C, device="meta")
    q = qkv.view(1, N, 3, H, D)
    return {
        "mha_fused": lambda: tat.mha_fused(q[:, :, 0], q[:, :, 1],
                                           q[:, :, 2], D**-0.5),
        "qkv_attention": lambda: tat.qkv_attention(qkv, H, inv),
        "vit_block.attention": lambda: tvb.attention(qkv, H),
        "attention_ablation": lambda: tabl.attention_ablation(
            qkv, H, inv, "cast"),
        "attention_heads": lambda: tabl.attention_heads(
            torch.zeros(3, 2, N, D, dtype=dtype, device="meta")),
    }


@pytest.mark.parametrize("wrapper", ["mha_fused", "qkv_attention",
                                     "vit_block.attention",
                                     "attention_ablation", "attention_heads"])
@pytest.mark.parametrize("N,D,limit", [
    (192, 72, "multiple of 16"), (192, 144, "up to 128"),
    (257, 64, "1 to 256 tokens"), (192, 8, "multiple of 16")])
def test_wrappers_refuse_shapes_past_the_kernel_limits(wrapper, N, D, limit):
    """The tensor-core kernel takes D a multiple of 16 up to 128 and up to
    256 tokens (a row of logits in registers); every wrapper's kernel path
    refuses the rest with a ValueError that names the limit, before any
    launch. Meta tensors reach the kernel path with ``on_cpu`` patched."""
    with mock.patch.object(tat, "on_cpu", lambda t: False), \
            mock.patch.object(tvb, "_on_cpu", lambda t: False), \
            mock.patch.object(tabl, "on_cpu", lambda t: False), \
            pytest.raises(ValueError, match=limit):
        _meta_calls(N, D)[wrapper]()


def test_f32_route_refuses_a_head_past_shared_memory():
    """Both f32 routes of ``mha_fused`` hold K and V of a head in shared
    memory: 256 tokens of head dim 128 fit neither (the tensor-core route's
    padded K and V take 274,432 bytes, the CUDA-core loop's buffers 275,456,
    of 232,448)."""
    with mock.patch.object(tat, "on_cpu", lambda t: False), \
            pytest.raises(ValueError, match="shared memory"):
        _meta_calls(256, 128, torch.float32)["mha_fused"]()


@pytest.mark.parametrize("N,D", [(192, 72), (300, 64)])
def test_f32_route_takes_shapes_past_the_tensor_core_limits(N, D):
    """The bf16 route's limits (D a multiple of 16, up to 256 tokens) do not
    bind f32 ``mha_fused``: (192, 72) takes the f32 tensor-core route (D
    padded to a multiple of 8), (300, 64) the CUDA-core loop, and the
    wrapper reaches the launch."""
    with mock.patch.object(tat, "on_cpu", lambda t: False), \
            mock.patch.object(tat.LIBRARY, "launch") as launch:
        _meta_calls(N, D, torch.float32)["mha_fused"]()
    assert launch.call_count == 1


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
