"""Fused linear blend skinning and its gradient: hand-written CUDA kernels
and their plain PyTorch twins (port of ``hands_tpu/ops/mano_pallas.py:
lbs_apply``).

Step 6 of :func:`hands_tpu_torch.ops.mano.mano_forward`: the per-vertex
transform ``T = lbs_weights . A`` applied to ``[v_posed, 1]``. The twin
stores ``T`` (B, 778, 4, 4); the kernels of ``csrc/lbs.cu`` blend per vertex
in registers and store only the posed vertices (forward) or the gradients
of ``v_posed`` and ``A`` (backward).

:func:`lbs_apply` runs through one ``autograd.Function`` on either device:
on CUDA tensors it launches the forward kernel and, in the backward, the
gradient kernel (one launch each, counted in :data:`launches`); on CPU
tensors it runs :func:`lbs_apply_plain` and :func:`lbs_apply_bwd_plain`;
any other device raises. The forward kernel is also the op
``hands_tpu_torch::lbs_apply`` (``cuda_build.KernelOp``), which a
``torch.export`` of a MANO decode records. The gradient of ``lbs_weights``
(a buffer of the MANO model, asked for by no path) is autograd of the twin
on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops.cuda_build import (CudaLibrary, KernelOp, check,
                                           on_cpu)

NUM_JOINTS = 16
BWD_MAX_VERTS = 1024  # the backward kernel stages a sample's g and v_posed

# kernel launches since the last reset (CPU twin runs are not counted)
launches: Dict[str, int] = {"lbs_apply": 0, "lbs_apply_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("lbs_apply", [i, p, p, p, p, i, i, p]),
                       ("lbs_apply_bwd", [i, p, p, p, p, p, p, i, i, p]),
                       # measurement only (chip_smoke.lbs_alone): the floor
                       ("lbs_empty", [i, i, i, p]),
                       ("lbs_copy", [i, p, p, i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


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


@f32_matmuls
def lbs_apply_bwd_plain(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
                        A: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`lbs_apply_plain` for ``g`` = d out (B, V, 3),
    written out: (d v_posed (B, V, 3), d A (B, 16, 4, 4)).

    d v_posed = T[:3, :3]^T g per vertex; d A[j, r] = sum_v W[v, j] g_r
    [v, 1] for r < 3 (the products g_r vh_c rounded as autograd rounds d T),
    and 0 for row 3."""
    T3 = torch.einsum("vj,bjrc->bvrc", lbs_weights, A[:, :, :3, :3])
    dv = torch.einsum("bvrc,bvr->bvc", T3, g)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    dT = g[..., :, None] * v_homo[..., None, :]  # (B, V, 3, 4)
    dA = torch.einsum("vj,bvrc->bjrc", lbs_weights, dT)
    return dv, torch.cat([dA, torch.zeros_like(dA[:, :, :1])], dim=2)


def _check_operands(v_posed, lbs_weights, A, g=None, layout=True) -> None:
    """Raise unless the operands are f32 (B, V, 3), (V, 16), (B, 16, 4, 4)
    [, (B, V, 3)] on one device; ``layout``: also contiguous and 16-byte
    aligned, as the kernels take them."""
    if v_posed.dim() != 3:
        raise ValueError(f"v_posed: want (B, V, 3), got {tuple(v_posed.shape)}")
    B, V, _ = v_posed.shape
    named = [("v_posed", v_posed, (B, V, 3)),
             ("lbs_weights", lbs_weights, (V, NUM_JOINTS)),
             ("A", A, (B, NUM_JOINTS, 4, 4))]
    if g is not None:
        named.append(("grad", g, (B, V, 3)))
    for name, t, shape in named:
        check(t, name, torch.float32, shape, v_posed.device, layout=layout)


def launch_lbs_apply(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
                     A: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch function (checks, launch, count): the
    body of the op ``hands_tpu_torch::lbs_apply``."""
    _check_operands(v_posed, lbs_weights, A)
    B, V, _ = v_posed.shape
    out = torch.empty_like(v_posed)
    LIBRARY.launch("lbs_apply", v_posed.device, v_posed.data_ptr(),
                   lbs_weights.data_ptr(), A.data_ptr(), out.data_ptr(), B, V)
    launches["lbs_apply"] += 1
    return out


LBS_APPLY = KernelOp(
    "lbs_apply", launch_lbs_apply,
    lambda v_posed, lbs_weights, A: torch.empty_like(v_posed))


def _launch_bwd(v_posed, lbs_weights, A, g):
    _check_operands(v_posed, lbs_weights, A, g)
    B, V, _ = v_posed.shape
    dv, dA = torch.empty_like(v_posed), torch.empty_like(A)
    LIBRARY.launch("lbs_apply_bwd", v_posed.device, v_posed.data_ptr(),
                   lbs_weights.data_ptr(), A.data_ptr(), g.data_ptr(),
                   dv.data_ptr(), dA.data_ptr(), B, V)
    launches["lbs_apply_bwd"] += 1
    return dv, dA


def _on_kernel(v_posed, lbs_weights, A, g=None) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    twins); raises on what neither takes: another device, another dtype
    than f32, shapes other than (B, V, 3), (V, 16), (B, 16, 4, 4) [, (B, V,
    3)]. The launch functions also refuse tensors that are not contiguous
    and 16-byte aligned (what the kernels take)."""
    cpu = on_cpu(v_posed)
    _check_operands(v_posed, lbs_weights, A, g, layout=False)
    return not cpu


def lbs_apply_bwd(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
                  A: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`lbs_apply` for ``g`` = d out: (d v_posed,
    d A), f32; the kernel on CUDA tensors (one launch), the twin on CPU."""
    if not _on_kernel(v_posed, lbs_weights, A, g):
        return lbs_apply_bwd_plain(v_posed, lbs_weights, A, g)
    if v_posed.shape[1] > BWD_MAX_VERTS:
        raise ValueError(f"lbs_apply_bwd: at most {BWD_MAX_VERTS} vertices, "
                         f"got {v_posed.shape[1]}")
    if v_posed.shape[0] == 0:
        return torch.empty_like(v_posed), torch.empty_like(A)
    return _launch_bwd(v_posed, lbs_weights, A, g)


class _LbsApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_posed, lbs_weights, A):
        ctx.save_for_backward(v_posed, lbs_weights, A)
        if v_posed.is_cuda:
            return LBS_APPLY(v_posed, lbs_weights, A)
        return lbs_apply_plain(v_posed, lbs_weights, A)

    @staticmethod
    def backward(ctx, grad_out):
        v_posed, lbs_weights, A = ctx.saved_tensors
        need_v, need_w, need_a = ctx.needs_input_grad
        dv = dw = dA = None
        if need_v or need_a:
            g = grad_out.contiguous()
            if g.data_ptr() % 16:  # a view into a larger gradient
                g = g.clone()
            dv, dA = lbs_apply_bwd(v_posed, lbs_weights, A, g)
        if need_w:  # no path asks for it (a buffer): autograd of the twin
            with torch.enable_grad():
                w = lbs_weights.detach().requires_grad_(True)
                dw, = torch.autograd.grad(
                    lbs_apply_plain(v_posed, w, A), w, grad_out)
        return (dv if need_v else None), dw, (dA if need_a else None)


def lbs_apply(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
              A: torch.Tensor) -> torch.Tensor:
    """Fused skinning: (B, V, 3), (V, 16), (B, 16, 4, 4) -> (B, V, 3), f32."""
    kernel = _on_kernel(v_posed, lbs_weights, A)
    if kernel and v_posed.shape[0] == 0:
        return torch.empty_like(v_posed)
    return _LbsApply.apply(v_posed, lbs_weights, A)
