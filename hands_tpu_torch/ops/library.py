"""The port's hand-written kernels as ``torch.library`` ops: importing this
module registers every ``hands_tpu_torch::*`` op that an exported serving
program (``cli/export.py``) holds, so that ``torch.export.load`` can read
such a program and run it on the card without the model code.

    import torch
    import hands_tpu_torch.ops.library  # noqa: F401  (registers the ops)
    program = torch.export.load("serving.pt2").module()

Each op's body is its kernel's launch function (``cuda_build.KernelOp``):
the checks, the ``ctypes`` launch and the launch count, so a loaded program
counts its launches in the modules' ``launches`` dicts as live serving does.
"""

from __future__ import annotations

from typing import Dict

from hands_tpu_torch.ops import attention, mano_lbs, vit_block, vit_block_int8
from hands_tpu_torch.ops.cuda_build import OP_NAMESPACE, KernelOp

# ``hands_tpu_torch::<name>`` -> its KernelOp
OPS: Dict[str, KernelOp] = {
    op.name: op for op in (
        vit_block.LAYERNORM, vit_block.GEMM, vit_block.ATTENTION,
        vit_block_int8.LN_QUANT_DYNAMIC, vit_block_int8.LN_QUANT_STATIC,
        vit_block_int8.QUANT_ROWS, vit_block_int8.GEMM_I8,
        attention.QKV_ATTENTION, mano_lbs.LBS_APPLY)}


def graph_ops(graph) -> Dict[str, int]:
    """{``hands_tpu_torch::<name>``: nodes} of an FX graph (an
    ``ExportedProgram``'s ``graph``)."""
    counts: Dict[str, int] = {}
    for node in graph.nodes:
        target = node.target
        if (node.op == "call_function"
                and getattr(target, "namespace", None) == OP_NAMESPACE):
            name = target.name().split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return dict(sorted(counts.items()))
