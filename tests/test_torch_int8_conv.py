"""Port parity of the W8A8 serving convolution: ``quantize_int8``,
``int8_conv``, ``Int8Conv`` and ``serving_conv_cls`` of
``hands_tpu_torch.ops.quant`` against ``hands_tpu.ops.quant``.

The port takes NCHW tensors and OIHW kernels, the JAX functions NHWC and
HWIO; the test transposes. Tolerances: the int8 values and their scales are
equal (the scale is ``max(amax, eps) * f32(1/127)``, as XLA compiles the
division by a constant); the int32 sums are exact on both sides, so the
dequantised output agrees to one f32 ulp of its largest term (1e-6 relative
to the output's maximum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.ops import quant as jq
from hands_tpu_torch.models.backbones.resnet import Conv
from hands_tpu_torch.ops import quant as tq


@pytest.mark.parametrize("axes", [None, (1, 2, 3), (0, 1, 2)])
def test_quantize_int8_matches_jax(axes):
    x = np.random.RandomState(0).randn(3, 5, 6, 7).astype(np.float32) * 3
    x[0, 0, 0, 0] = 0.0
    q_ref, s_ref = jq.quantize_int8(jnp.asarray(x), axes=axes)
    q, s = tq.quantize_int8(torch.from_numpy(x), axes=axes)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert q.dtype == torch.int8


@pytest.mark.parametrize("k,stride,pad,cin,cout", [
    (3, 1, 1, 16, 24), (3, 2, 1, 16, 24), (1, 1, 0, 32, 8), (1, 2, 0, 32, 8),
    (3, 1, 0, 5, 3)])
def test_int8_conv_matches_jax(k, stride, pad, cin, cout):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 9, 9, cin).astype(np.float32)  # NHWC
    x[1] *= 7.0  # per-sample scales differ
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    ref = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(w),
                                  (stride, stride), [(pad, pad), (pad, pad)]))
    got = tq.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
    # and it is a quantised product: close to the f32 convolution, not equal
    exact = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride, padding=pad)
    err = np.abs(exact.permute(0, 2, 3, 1).numpy() - got).max()
    assert 0 < err < 0.1 * float(np.abs(ref).max())


def test_int_conv_is_exact_at_the_largest_depth():
    """127 * 127 * 4608 overflows f32's 24 bits; the f64 route does not."""
    xq = torch.full((1, 512, 3, 3), 127, dtype=torch.int8)
    wq = torch.full((2, 512, 3, 3), -127, dtype=torch.int8)
    wq[1] = 127
    out = tq._int_conv(xq, wq, 1, 0)
    assert out.shape == (1, 2, 1, 1)
    assert [int(v) for v in out.flatten()] == [-127 * 127 * 4608,
                                               127 * 127 * 4608]


def test_int8_conv_module_and_class_switch():
    assert tq.serving_conv_cls(True) is tq.Int8Conv
    assert tq.serving_conv_cls(False) is Conv
    plain = Conv(8, 4, 3, 1, 1)
    torch.nn.init.normal_(plain.weight, std=0.1)
    quant = tq.Int8Conv(8, 4, 3, 1, 1, dtype=torch.bfloat16)
    quant.load_state_dict(plain.state_dict())  # same names and shapes
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = plain(x), quant(x)
    assert b.dtype == torch.bfloat16 and a.shape == b.shape
    assert float((a - b.float()).abs().max()) < 0.05
