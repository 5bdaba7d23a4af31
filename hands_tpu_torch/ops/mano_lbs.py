"""Fused linear blend skinning: a hand-written CUDA kernel and its plain
PyTorch twin (port of ``hands_tpu/ops/mano_pallas.py:lbs_apply``).

Step 6 of :func:`hands_tpu_torch.ops.mano.mano_forward`: the per-vertex
transform ``T = lbs_weights . A`` applied to ``[v_posed, 1]``. The twin
stores ``T`` (B, 778, 4, 4); the kernel of ``csrc/lbs.cu`` blends and applies
per vertex in registers and stores only the posed vertices.

CUDA tensors launch the kernel (one launch, counted in :data:`launches`); CPU
tensors run :func:`lbs_apply_plain`; anything else raises. The JAX kernel has
no backward kernel, so the backward here recomputes through the twin.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops.cuda_build import CudaLibrary, check, on_cpu

NUM_JOINTS = 16

# kernel launches since the last reset (CPU twin runs are not counted)
launches: Dict[str, int] = {"lbs_apply": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lbs_apply.argtypes = [i, p, p, p, p, i, i, p]
    lib.lbs_apply.restype = ctypes.c_int


LIBRARY = CudaLibrary("lbs", _bind, "lbs_error_string")


@f32_matmuls
def lbs_apply_plain(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
                    A: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) posed-template vertices, (V, 16) skinning weights,
    (B, 16, 4, 4) joint transforms -> (B, V, 3) skinned vertices, as two
    plain products."""
    T = torch.einsum("vj,bjrc->bvrc", lbs_weights, A)  # (B, V, 4, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.einsum("bvrc,bvc->bvr", T, v_homo)[..., :3]


class _LbsApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_posed, lbs_weights, A):
        B, V, _ = v_posed.shape
        out = torch.empty_like(v_posed)
        LIBRARY.launch("lbs_apply", v_posed.device, v_posed.data_ptr(),
                       lbs_weights.data_ptr(), A.data_ptr(), out.data_ptr(),
                       B, V)
        launches["lbs_apply"] += 1
        ctx.save_for_backward(v_posed, lbs_weights, A)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        # no backward kernel (the TPU kernel has none): differentiate the twin
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = lbs_apply_plain(*ins)
            got = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, needs) if n], grad_out))
        return tuple(next(got) if n else None for n in needs)


def lbs_apply(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
              A: torch.Tensor) -> torch.Tensor:
    """Fused skinning: (B, V, 3), (V, 16), (B, 16, 4, 4) -> (B, V, 3), f32."""
    if on_cpu(v_posed):
        return lbs_apply_plain(v_posed, lbs_weights, A)
    B, V, _ = v_posed.shape
    dev = v_posed.device
    if B == 0:
        return torch.empty_like(v_posed)
    check(v_posed, "v_posed", torch.float32, (B, V, 3), dev)
    check(lbs_weights, "lbs_weights", torch.float32, (V, NUM_JOINTS), dev)
    check(A, "A", torch.float32, (B, NUM_JOINTS, 4, 4), dev)
    return _LbsApply.apply(v_posed, lbs_weights, A)
