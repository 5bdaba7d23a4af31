"""Float32 precision pin: the PyTorch form of ``jax.default_matmul_precision
("float32")`` that the JAX package wraps around its geometry.

On an NVIDIA card a float32 convolution goes through cuDNN in TF32 by
default, and a float32 matmul may too when ``allow_tf32`` is set. TF32 keeps
about three decimal digits, which breaks the geometry's parity contract, so
geometry and preprocessing run inside :func:`f32_exact`.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def f32_exact():
    """TF32 off for matmuls and cuDNN convolutions; restores the previous
    flags on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def f32_matmuls(fn):
    """Decorator form of :func:`f32_exact`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_exact():
            return fn(*args, **kwargs)

    return wrapped
