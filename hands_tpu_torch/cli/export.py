"""Export the serving path as one ``torch.export`` program (port of
``hands_tpu/cli/export.py``).

The artifact packages the whole serving program: raw uint8 record batch ->
on-device preprocessing (crop, KPE, normalisation) -> model forward -> MANO
predictions, as one ``ExportedProgram`` written by ``torch.export.save``.
Shapes are static (the batch size and ``raw_hw``), as in the JAX artifact.

    python -m hands_tpu_torch.cli.export --method hands_light \\
        --batch_size 64 [--ckpt logs/<key>/checkpoints/last] [--device cpu] \\
        [--raw_hw 840x600] [--int8 --fast_gelu --fused_block] -o serving.pt2
    python -m hands_tpu_torch.cli.export --method hamer_light --fused_block \\
        --batch_size 8 --raw_hw 512x640 --aoti -o serving.pt2  # a package
    python -m hands_tpu_torch.cli.export --run serving.pt2   # smoke-execute

Input contract (written to the ``.json`` sidecar): the dict of
``data/device_pipeline.stack_records`` for a batch of ``batch_size`` records
whose images are zero-padded to ``raw_hw``, as tensors on the artifact's
device. Output: the model's prediction dict (plain str -> tensor).

On the card (``--device cuda``, the default; it raises without a card) the
program holds the hand-written kernels of the serving path as the ops
``hands_tpu_torch::*`` (``ops/library.py``): K3's three kernels, or K5's and
K6's, for HaMeR, and K1's skinning for every family. The sidecar's
``kernels`` counts them. The int8 blocks' prepared operands (int8 weights,
scale vectors, folded LayerNorm parameters) are the program's state, under
the names ``kernel_operands`` lists; the f32 parameters they were prepared
from are not in the artifact. A CPU artifact (``--device cpu``) holds the
plain PyTorch twins and no kernel op: its ``kernels`` is empty.

``--aoti`` writes ``<out>`` as an AOTInductor package instead
(``torch._inductor.aoti_compile_and_package`` of the same program, its
weights inside): compiled code that loads, like the JAX artifact, with
nothing but the framework: ``torch`` and, for a CUDA package, the kernels'
ops library that the sidecar names (``ops_library``), copied beside the
package with the per-source kernel libraries it links
(``ops_library_files``). That library registers the kernels' ops from C++
(``csrc/torch_ops.cpp``, ``hands_tpu_torch_aoti::*``; the program's
``hands_tpu_torch::*`` nodes are pointed at them before the compile,
``ops/library.py:retarget``), so no ``hands_tpu_torch`` module is imported:

    import json, os, torch
    side = json.load(open("serving.pt2.json"))
    if side["ops_library"]:  # a CUDA package: register the kernels' ops
        torch.ops.load_library(os.path.join(".", side["ops_library"]))
    run = torch._inductor.aoti_load_package("serving.pt2")
    torch.backends.cuda.matmul.allow_tf32 = False  # as live serving
    torch.backends.cudnn.allow_tf32 = False
    out = run(raw)  # raw: input_spec's tensors on the package's device

Without the ops library a CUDA package does not load (its kernel ops have
no schema); a failed launch inside an op raises. ``--device cpu --aoti``
compiles the twins' program, which calls no kernel op. A ``torch.export``
artifact (no ``--aoti``) needs ``torch`` and the Python op registrations:
one import of ``hands_tpu_torch.ops.library``, which brings the kernel
modules and no model code. Either runs its f32 products as live serving
does only with TF32 off (``core.precision.f32_exact``); :func:`run_artifact`
turns it off and reads the sidecar's ``format`` to pick the loader.

``--params_args`` exports ``serve(state, raw)``: the state (parameters,
buffers, prepared operands) goes in as an argument and is written to
``<out>.weights.pt``, so the program file holds no weights. ``--ckpt`` serves
a checkpoint of ``cli.train`` or ``cli.convert_ckpt``
(``train.checkpoint.load_serving_checkpoint``); without it the weights are
random from seed 0 (a plumbing smoke only).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch import nn


def _tensors(pred) -> dict:
    return {k: v for k, v in pred.items() if torch.is_tensor(v)}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class ServingModule(nn.Module):
    """Raw stacked record batch -> plain dict of prediction tensors: eval
    preprocessing (which draws no augmentation) and the model."""

    def __init__(self, cfg, model: nn.Module):
        from hands_tpu_torch.data.device_pipeline import DevicePreprocessor

        super().__init__()
        self.model = model
        self.pre = DevicePreprocessor(cfg, is_train=False,
                                      device=_device(model))

    def forward(self, raw: dict) -> dict:
        inputs, _, meta = self.pre._process(raw)
        return _tensors(self.model(inputs, meta))


class ServingParamsModule(nn.Module):
    """:class:`ServingModule` with the state as an argument: ``forward(state,
    raw)`` runs the model through ``torch.func.functional_call`` on
    ``state`` (:func:`serving_state`)."""

    def __init__(self, cfg, model: nn.Module):
        from hands_tpu_torch.data.device_pipeline import DevicePreprocessor

        super().__init__()
        # not a submodule: an exported program would hold its state
        self.__dict__["model"] = model
        self.pre = DevicePreprocessor(cfg, is_train=False,
                                      device=_device(model))

    def forward(self, state: dict, raw: dict) -> dict:
        inputs, _, meta = self.pre._process(raw)
        return _tensors(torch.func.functional_call(self.model, state,
                                                   (inputs, meta)))


def build_serving_fn(cfg, model: nn.Module) -> nn.Module:
    """Raw stacked record batch -> plain dict of prediction tensors, the
    model's state inside (exported with the program)."""
    return ServingModule(cfg, model)


def build_serving_fn_params_arg(cfg, model: nn.Module) -> nn.Module:
    """Like :func:`build_serving_fn`, but the module takes ``(state, raw)``:
    the program holds no weights, they load once from the weights file."""
    return ServingParamsModule(cfg, model)


def serving_state(model: nn.Module) -> dict:
    """Every parameter and buffer of ``model`` by name: the state
    :class:`ServingParamsModule` takes."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@contextlib.contextmanager
def kernel_state(model: nn.Module):
    """Within: every int8 kernel block of ``model`` holds its prepared
    operands as buffers (``Block.hold_prepared``) and hides the parameters
    they were prepared from, which its forward does not read. Yields the
    held buffers' names. On exit the parameters come back and the buffers
    go; the prepared cache stays."""
    from hands_tpu_torch.models.backbones.vit import Block

    hidden, held = [], []
    try:
        for block in model.modules():
            if not (isinstance(block, Block) and block.fused
                    and block.quant_int8 and not block.training):
                continue
            block.hold_prepared()
            held.append(block)
            for mod in block.modules():
                hidden.append((mod, dict(mod._parameters)))
                mod._parameters.clear()
        yield sorted(k for k, _ in model.named_buffers()
                     if "int8_operands" in k.split("."))
    finally:
        for mod, params in hidden:
            mod._parameters.update(params)
        for block in held:
            del block.int8_operands


def example_raw_batch(cfg, batch_size: int, raw_hw, device="cpu") -> dict:
    """A representative stacked raw batch fixing the artifact's shapes, as
    tensors on ``device``."""
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import stack_records

    ds = SyntheticRecordDataset(cfg, "train", length=min(batch_size, 8),
                                img_hw=tuple(raw_hw))
    stacked = stack_records([ds[i % len(ds)] for i in range(batch_size)])
    return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()
            if not k.startswith("_")}


def export_serving(cfg, model: nn.Module, batch_size: int,
                   raw_hw=(840, 600), params_as_args: bool = False):
    """Export the serving program on the model's device; returns
    ``(ExportedProgram, example raw batch, kernel operand names)``.
    ``params_as_args=True`` exports ``serve(state, raw)``
    (:func:`build_serving_fn_params_arg`); the caller ships the state
    (:func:`serving_state`, inside :func:`kernel_state`)."""
    raw = example_raw_batch(cfg, batch_size, raw_hw, _device(model))
    with torch.no_grad(), kernel_state(model) as operands:
        if params_as_args:
            serve = build_serving_fn_params_arg(cfg, model)
            args = (serving_state(model), raw)
        else:
            serve = build_serving_fn(cfg, model)
            args = (raw,)
        program = torch.export.export(serve, args, strict=False)
    # torch.export.save would write the example batch (and the state of an
    # args-mode program) into the artifact
    program.example_inputs = None
    return program, raw, operands


def load_artifact(path: str):
    """(callable raw -> predictions, sidecar) of an artifact or a package,
    by the sidecar's ``format``: a package needs only ``torch`` and its ops
    library, a ``torch.export`` artifact the op registrations
    (``ops/library.py``)."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    if sidecar.get("format") == "aoti":
        return load_package(path, sidecar), sidecar
    import hands_tpu_torch.ops.library  # noqa: F401  (the kernel ops)

    program = torch.export.load(path).module()
    if not sidecar.get("weights_file"):
        return program, sidecar
    wf = os.path.join(os.path.dirname(os.path.abspath(path)),
                      sidecar["weights_file"])
    state = torch.load(wf, map_location=sidecar["device"], weights_only=True)
    return (lambda raw: program(state, raw)), sidecar


def load_package(path: str, sidecar: dict):
    """The AOTInductor package at ``path``, loaded after its ops library
    (unless this process registered the C++ ops already)."""
    if sidecar["ops_library"]:
        from hands_tpu_torch.ops.library import load_ops_library

        load_ops_library(os.path.join(os.path.dirname(os.path.abspath(path)),
                                      sidecar["ops_library"]))
    return torch._inductor.aoti_load_package(path)


def run_artifact(path: str) -> dict:
    """Load an artifact and smoke-execute it on zeros, but for a unit crop
    box (``bbox`` scale 1): the crop transform of a zero box is singular,
    and ``torch.linalg.inv`` raises where XLA returns infinities."""
    from hands_tpu_torch.core.precision import f32_exact

    program, sidecar = load_artifact(path)
    print(f"artifact: {sidecar['method']} bs={sidecar['batch_size']} "
          f"device={sidecar['device']} kernels={sidecar['kernels']}")
    dev = sidecar["device"]
    raw = {k: torch.zeros(spec["shape"], dtype=getattr(torch, spec["dtype"]),
                          device=dev)
           for k, spec in sidecar["input_spec"].items()}
    raw["bbox"][:, 2] = 1.0
    with torch.no_grad(), f32_exact():
        out = program(raw)
    for k in sorted(out):
        v = out[k]
        print(f"  {k}: {tuple(v.shape)} {str(v.dtype)[6:]} "
              f"finite={bool(torch.isfinite(v).all())}")
    return out


def _sidecar(program, raw: dict, operands, meta: dict) -> dict:
    """The sidecar's fields shared by an artifact and a package."""
    return {
        **meta,
        "batch_size": int(raw["image"].shape[0]),
        "raw_hw": list(raw["image"].shape[1:3]),
        "device": str(next(iter(raw.values())).device.type),
        "input_spec": {k: {"shape": list(v.shape), "dtype": str(v.dtype)[6:]}
                       for k, v in raw.items()},
        "output_keys": sorted(program.call_spec.out_spec.context or []),
        "kernel_operands": list(operands),
    }


def _write_sidecar(out: str, sidecar: dict) -> dict:
    if sidecar["device"] == "cpu":
        sidecar["kernels_note"] = ("a CPU artifact holds the plain PyTorch "
                                   "twins of the kernels, no kernel op")
    with open(out + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    return sidecar


def write_artifact(out: str, program, raw: dict, operands, meta: dict,
                   state=None) -> dict:
    """Save ``program`` to ``out``, ``state`` (if given) to
    ``<out>.weights.pt`` and the sidecar to ``<out>.json``; returns the
    sidecar. ``meta`` holds the sidecar's configuration fields."""
    from hands_tpu_torch.ops.library import graph_ops

    torch.export.save(program, out)
    weights_file = ""
    if state is not None:
        weights_file = os.path.basename(out) + ".weights.pt"
        torch.save(state, os.path.join(
            os.path.dirname(os.path.abspath(out)), weights_file))
    sidecar = _sidecar(program, raw, operands, meta)
    sidecar.update(weights_file=weights_file, kernels=graph_ops(program.graph))
    return _write_sidecar(out, sidecar)


def openmp_cxx() -> str:
    """The first C++ compiler (``$CXX``, then ``g++``, ``c++``,
    ``clang++`` along ``PATH``) that links an OpenMP program: AOTInductor
    links its C++ wrapper with ``-fopenmp``, which a compiler without
    OpenMP's spec file refuses."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for name in ("g++", "c++", "clang++"):
        names += [os.path.join(d, name)
                  for d in os.environ.get("PATH", "").split(os.pathsep) if d]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        for cxx in dict.fromkeys(names):
            if shutil.which(cxx) and subprocess.run(
                    [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "a")],
                    capture_output=True).returncode == 0:
                return cxx
    raise RuntimeError("no C++ compiler on PATH links -fopenmp, which "
                       "AOTInductor's build needs (set CXX)")


def write_package(out: str, program, raw: dict, operands, meta: dict
                  ) -> dict:
    """Compile ``program`` with AOTInductor into the package ``out`` (a
    ``.pt2`` path), its weights inside. On the card the program's kernel
    ops are first pointed at their C++ registration (``retarget``: the
    graph changes in place) and the ops library is copied beside ``out``.
    Writes the sidecar (``format: "aoti"``) to ``<out>.json`` and returns
    it, with the compile's seconds under ``compile_s``."""
    from hands_tpu_torch.core.precision import f32_exact
    from hands_tpu_torch.ops import library

    sidecar = _sidecar(program, raw, operands, meta)
    files, kernels = [], {}
    if sidecar["device"] == "cuda":
        library.load_ops_library()
        kernels = library.retarget(program)
        files = library.OPS_LIBRARY.files()
    program.example_inputs = ((raw,), {})
    t0 = time.time()
    try:
        with torch.no_grad(), f32_exact():
            torch._inductor.aoti_compile_and_package(
                program, package_path=out,
                inductor_configs={"cpp.cxx": (None, openmp_cxx())})
    finally:
        program.example_inputs = None
    compile_s = time.time() - t0
    where = os.path.dirname(os.path.abspath(out))
    for f in files:
        shutil.copy2(f, os.path.join(where, f.name))
    sidecar.update(format="aoti", weights_file="", kernels=kernels,
                   ops_library=files[0].name if files else "",
                   ops_library_files=[f.name for f in files])
    _write_sidecar(out, sidecar)
    return {**sidecar, "compile_s": compile_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--method", default="hands_light")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--ckpt", default="", help="checkpoint file of cli.train "
                   "or cli.convert_ckpt (<dir>/last); random weights from "
                   "seed 0 if omitted (plumbing smoke only)")
    p.add_argument("--raw_hw", default="840x600",
                   help="raw record image HxW the artifact accepts (inputs "
                        "must be zero-padded to this, like cli.demo --dir "
                        "chunks)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the artifact's device (cuda raises without a card)")
    p.add_argument("--backbone", default=None,
                   help="override cfg.backbone (e.g. resnet18)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fused_block", action="store_true")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--fast_gelu", action="store_true")
    p.add_argument("--vit_depth", type=int, default=0,
                   help="keep the ViT's first N blocks, widths whole (a "
                        "shallow program for a quick check; 0: all)")
    p.add_argument("--params_args", action="store_true",
                   help="take the state as an argument, written to "
                        "<out>.weights.pt, instead of inside the program")
    p.add_argument("--aoti", action="store_true",
                   help="write <out> as an AOTInductor package (and, on the "
                        "card, the kernels' ops library beside it)")
    p.add_argument("-o", "--out", default="serving.pt2")
    p.add_argument("--run", default="",
                   help="instead of exporting: load and execute the given "
                        "artifact on zero inputs")
    args = p.parse_args(argv)

    if args.run:
        run_artifact(args.run)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; export a CPU "
                           "artifact with --device cpu")
    if args.aoti and (args.params_args or not args.out.endswith(".pt2")):
        raise ValueError("--aoti writes a .pt2 package with its weights "
                         "inside (no --params_args)")

    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.models.registry import fetch_model

    overrides = dict(compute_dtype=args.dtype, use_render_seg_loss=False,
                     use_grasp_loss=False, fused_block=args.fused_block,
                     quant_int8=args.int8, fast_gelu=args.fast_gelu)
    if args.backbone:
        overrides["backbone"] = args.backbone
    cfg = default_config(args.method, **overrides)
    model = fetch_model(cfg, device=args.device, seed=0)
    if args.ckpt:
        from hands_tpu_torch.train.checkpoint import load_serving_checkpoint

        load_serving_checkpoint(model, args.ckpt)
    if args.vit_depth:
        bb = getattr(model.net, "backbone", None)
        if not hasattr(bb, "blocks"):
            raise ValueError(f"--vit_depth: {args.method} has no ViT")
        bb.blocks = bb.blocks[:args.vit_depth]

    raw_hw = tuple(int(v) for v in args.raw_hw.split("x"))
    program, raw, operands = export_serving(
        cfg, model, args.batch_size, raw_hw, params_as_args=args.params_args)
    state = None
    if args.params_args:
        with kernel_state(model):
            state = {k: v.detach() for k, v in serving_state(model).items()}
    meta = {"method": args.method, "dtype": args.dtype,
            "fused_block": cfg.fused_block, "quant_int8": cfg.quant_int8,
            "fast_gelu": args.fast_gelu, "ckpt": args.ckpt,
            "vit_depth": args.vit_depth}
    if args.aoti:
        sidecar = write_package(args.out, program, raw, operands, meta)
    else:
        sidecar = write_artifact(args.out, program, raw, operands, meta,
                                 state)
    size = os.path.getsize(args.out) / 1e6
    compiled = (f"; compiled in {sidecar['compile_s']:.1f} s"
                if args.aoti else "")
    print(f"exported {args.method} bs={args.batch_size} "
          f"device={sidecar['device']} kernels={sidecar['kernels']} -> "
          f"{args.out} ({size:.1f} MB + sidecar{compiled})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
