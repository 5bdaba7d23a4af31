"""The serving export's compiled form (``cli/export.py --aoti``) and the
kernels' ops registered from C++ (``csrc/torch_ops.cpp``), on the CPU.

- A CPU package (AOTInductor, compiled once for the module) of the small
  ArcticSF that ``test_torch_export.arctic`` exports (ResNet-18, raw 64x48,
  B = 2, f32) equals the ``torch.export`` artifact at 1e-5 (Inductor fuses
  and reorders the f32 glue) and the JAX package's jitted
  ``build_serving_fn`` at ``test_torch_hands_light.RTOL``.
- A ``python -c`` process that imports ``torch`` and no ``hands_tpu*``
  module loads the package and returns outputs equal to the in-process run.
- Each ``m.def`` of ``csrc/torch_ops.cpp`` has the schema of its Python op
  (``ops/library.py:OPS``): names, types, returns.
- ``ops/library.retarget`` points every ``hands_tpu_torch::*`` node of the
  K3, K5 and K6 block exports at ``hands_tpu_torch_aoti::*`` with the counts
  unchanged. The C++ library links the CUDA kernels, which this machine
  cannot build, so its schemas are registered here from the ``m.def``
  strings; the library itself, its launches and a CUDA package run on the
  card (``chip_smoke.py``, phases 17 and 17b).
"""

import json
import os
import re
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.operator_schemas import normalize_function

from hands_tpu.cli.export import build_serving_fn as jax_serving_fn
from hands_tpu_torch.cli import export as ex
from hands_tpu_torch.models.backbones.vit import Block
from hands_tpu_torch.ops import library
from hands_tpu_torch.ops.cuda_build import CSRC, OP_NAMESPACE
from test_torch_export import CLI, ROUTES, arctic, close  # noqa: F401
from test_torch_hands_light import RTOL, max_rel

PACKAGE_TOL = 1e-5
# The module's CPU package compiles with Inductor's C++ kernels scalar
# (no vector ISA: its probes and the tiling analysis of the vector loops took
# ~30 of the ~85 s of a cold compile) and the wrapper at -O0 (~6 s of its
# C++ compile), and both processes that load it skip the ISA probes (~16 s
# each on a cold cache; the package records no vector ISA to match). None
# of it changes the model, what is compared or a tolerance; the package's
# outputs on the example batch were bit-equal to a vectorised -O1 build's.
FAST_COMPILE = {"cpp.vec_isa_ok": False,
                "aot_inductor.compile_wrapper_opt_level": "O0"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def package(arctic, tmp_path_factory):  # noqa: F811
    """The CLI's CPU package of ``arctic``'s checkpoint, loaded and run on
    its example batch."""
    path = str(tmp_path_factory.mktemp("aoti") / "serving.pt2")
    with torch._inductor.config.patch(FAST_COMPILE):
        assert ex.main(CLI + ["--ckpt", arctic["ckpt"], "--aoti", "-o",
                              path]) == 0
        run, sidecar = ex.load_artifact(path)
    with torch.no_grad():
        out = run(arctic["raw"])
    return dict(path=path, sidecar=sidecar, out=out)


def test_cpu_package_matches_artifact_and_jax(arctic, package):  # noqa: F811
    side = package["sidecar"]
    assert side["format"] == "aoti" and side["device"] == "cpu"
    assert side["kernels"] == {} and side["ops_library"] == ""
    assert side["ops_library_files"] == [] and side["weights_file"] == ""
    assert sorted(package["out"]) == side["output_keys"]
    close(package["out"], arctic["out"], PACKAGE_TOL)
    jcfg, jmodel, variables, jraw = arctic["jax"]
    ref = jax.jit(jax_serving_fn(jcfg, jmodel, variables))(jraw)
    worst, per_key = max_rel(dict(ref), package["out"], per_tensor=True)
    assert worst <= RTOL, per_key


FRESH = """
import json, sys, torch
torch.set_num_threads(2)
run = torch._inductor.aoti_load_package(sys.argv[1])
raw = torch.load(sys.argv[2], weights_only=True)
with torch.no_grad():
    out = run(raw)
torch.save(out, sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.startswith("hands_tpu"))))
"""


def test_package_loads_without_the_port(arctic, package, tmp_path):  # noqa: F811
    """torch alone loads and runs the package (a CPU package calls no
    kernel op, so no ops library either)."""
    raw_p, out_p = str(tmp_path / "raw.pt"), str(tmp_path / "out.pt")
    torch.save(arctic["raw"], raw_p)
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "TORCHINDUCTOR_VEC_ISA_OK": "0"}  # FAST_COMPILE's, at load
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, package["path"], raw_p, out_p],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    got = torch.load(out_p, weights_only=True)
    assert set(got) == set(package["out"])
    for k, v in package["out"].items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------ the C++ registration
def cpp_schemas() -> dict:
    """{op name: schema string} of the ``m.def`` calls of torch_ops.cpp
    (adjacent string literals joined)."""
    text = (CSRC / "torch_ops.cpp").read_text()
    schemas = {}
    for call in re.findall(r'm\.def\(((?:\s*"[^"]*")+)\s*\)', text):
        schema = "".join(re.findall(r'"([^"]*)"', call))
        schemas[schema.split("(")[0]] = schema
    return schemas


def _signature(schema):
    return ([(a.name, str(a.type)) for a in schema.arguments],
            [str(r.type) for r in schema.returns])


def test_cpp_schemas_match_python_ops():
    schemas = cpp_schemas()
    assert sorted(schemas) == sorted(n.split("::")[1] for n in library.OPS)
    for name, op in library.OPS.items():
        short = name.split("::")[1]
        cpp = torch._C.parse_schema(
            f"{library.AOTI_NAMESPACE}::{schemas[short]}")
        python = op.op._opoverload._schema
        assert _signature(cpp) == _signature(python), short


@pytest.fixture(scope="module")
def aoti_schemas():
    """The C++ ops' schemas registered in this process (no kernel): what
    loading the library defines, for the graph rewrite to point at."""
    lib = torch.library.Library(library.AOTI_NAMESPACE, "FRAGMENT")
    for schema in cpp_schemas().values():
        lib.define(schema)
    yield
    lib._destroy()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_retarget_block_graph(route, aoti_schemas):
    """A ``fused_block`` block exported from fake CUDA inputs (as
    ``test_block_exports_its_kernel_ops``): after the rewrite no node calls a
    Python op, each C++ op appears as often as its Python op did, with the
    same schema, and every node's arguments bind to it."""
    kw, want = ROUTES[route]
    block_kw = dict(dim=64, num_heads=2, mlp_ratio=2.0, dtype=torch.bfloat16,
                    fused_block=True, **kw)
    ops = Block(**block_kw).prepared() if "quant_int8" in kw else None
    with FakeTensorMode():
        block = Block(device="cuda", **block_kw)
        if ops is not None:
            block._prepared = {k: torch.empty(v.shape, dtype=v.dtype,
                                              device="cuda")
                               for k, v in ops.items()}
        x = torch.empty(2, 5, 64, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad(), ex.kernel_state(block):
        program = torch.export.export(block, (x,), strict=False)
    before = {n.name: n.target for n in program.graph.nodes
              if getattr(n.target, "namespace", None) == OP_NAMESPACE}
    got = library.retarget(program)
    assert library.graph_ops(program.graph) == {}
    assert got == {f"{library.AOTI_NAMESPACE}::{k}": n
                   for k, n in sorted(want.items())}
    nodes = {n.name: n for n in program.graph.nodes}
    assert len(before) == sum(want.values())
    for name, old in before.items():
        node = nodes[name]
        assert node.target.namespace == library.AOTI_NAMESPACE
        assert _signature(node.target._schema) == _signature(old._schema)
        assert normalize_function(node.target, node.args, node.kwargs,
                                  normalize_to_only_use_kwargs=True)
