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

The same ops are also registered from C++ (``csrc/torch_ops.cpp``, built by
:data:`OPS_LIBRARY`) as ``hands_tpu_torch_aoti::<name>``, with the same
schemas: a launch path with no Python, which an AOTInductor package calls
(``cli/export.py --aoti``). :func:`retarget` points an exported program's
``hands_tpu_torch::*`` nodes at them before AOTInductor compiles it. The two
namespaces differ because the Python ops stay registered and one process
cannot register a name twice.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from hands_tpu_torch.ops import attention, mano_lbs, vit_block, vit_block_int8
from hands_tpu_torch.ops.cuda_build import (OP_NAMESPACE, KernelOp,
                                           TorchOpsLibrary)

# ``hands_tpu_torch::<name>`` -> its KernelOp
OPS: Dict[str, KernelOp] = {
    op.name: op for op in (
        vit_block.LAYERNORM, vit_block.GEMM, vit_block.ATTENTION,
        vit_block_int8.LN_QUANT_DYNAMIC, vit_block_int8.LN_QUANT_STATIC,
        vit_block_int8.QUANT_ROWS, vit_block_int8.GEMM_I8,
        attention.QKV_ATTENTION, mano_lbs.LBS_APPLY)}


AOTI_NAMESPACE = "hands_tpu_torch_aoti"
# the C++ registration of OPS; it calls the entries of these four libraries
OPS_LIBRARY = TorchOpsLibrary(
    "torch_ops", (vit_block.LIBRARY, vit_block_int8.LIBRARY,
                  attention.LIBRARY, mano_lbs.LIBRARY))


def _op_nodes(graph, namespace: str):
    for node in graph.nodes:
        if (node.op == "call_function"
                and getattr(node.target, "namespace", None) == namespace):
            yield node


def graph_ops(graph, namespace: str = OP_NAMESPACE) -> Dict[str, int]:
    """{``<namespace>::<name>``: nodes} of an FX graph (an
    ``ExportedProgram``'s ``graph``)."""
    counts: Dict[str, int] = {}
    for node in _op_nodes(graph, namespace):
        name = node.target.name().split(".")[0]
        counts[name] = counts.get(name, 0) + 1
    return dict(sorted(counts.items()))


def aoti_ops_registered() -> bool:
    """True once this process holds the C++ ops (a second registration of
    their namespace aborts the process)."""
    return hasattr(getattr(torch.ops, AOTI_NAMESPACE), "lbs_apply")


def load_ops_library(path: str = "") -> str:
    """Register the C++ ops in this process, from ``path`` (a copy of the
    library beside a package) or from :data:`OPS_LIBRARY`, built here;
    nothing if they are registered already. Returns the library's path."""
    path = path or str(OPS_LIBRARY.files()[0])
    if not aoti_ops_registered():
        torch.ops.load_library(os.path.abspath(path))
    return path


def retarget(program) -> Dict[str, int]:
    """Point every ``hands_tpu_torch::<name>`` node of ``program`` (an
    ``ExportedProgram``, changed in place) at ``hands_tpu_torch_aoti::<name>``,
    the C++ op of the same schema, which must be registered
    (:func:`load_ops_library`). Returns :func:`graph_ops` of the new
    namespace: the same counts as before."""
    namespace = getattr(torch.ops, AOTI_NAMESPACE)
    for node in list(_op_nodes(program.graph, OP_NAMESPACE)):
        name = node.target.name().split("::")[1].split(".")[0]
        if not hasattr(namespace, name):
            raise RuntimeError(f"{AOTI_NAMESPACE}::{name} is not registered: "
                               f"load the ops library first")
        node.target = getattr(getattr(namespace, name),
                              node.target._overloadname)
    program.graph_module.recompile()
    return graph_ops(program.graph, AOTI_NAMESPACE)
