"""The port's serving export (``hands_tpu_torch/cli/export.py``) and the
kernels' ``torch.library`` ops, on the CPU (mirrors tests/test_export.py).

- Round trip: ArcticSF (ResNet-18, raw 64x48, B = 2, f32) exported, saved,
  loaded and run equals the live serving module at 1e-6 (the JAX test's
  tolerance), and the JAX package's jitted ``build_serving_fn`` on the same
  weights and raw batch at ``test_torch_hands_light.RTOL`` (1e-4 of each
  output's scale, as tests/test_torch_families.py holds ArcticSF).
- The ``params_args`` program takes its state as an argument and holds no
  weights; the CLI writes the artifact, the weights file and the sidecar,
  and ``--run`` executes it.
- Each op's fake (shape) function, on fake CUDA tensors under
  ``FakeTensorMode``, gives the shapes and dtypes of its plain twin run on
  the CPU; one ViT block of each kernel route (K3, K5, K6) exported from
  fake CUDA inputs holds exactly that block's ops, and the int8 blocks'
  state is their prepared operands only. A whole model cannot be traced on
  fake CUDA tensors with the CPU build of PyTorch (its quantisation and
  parameter moves need CUDA support), so the whole CUDA program is checked
  on the card (chip_smoke.py, phase 17).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from hands_tpu.cli.export import build_serving_fn as jax_serving_fn
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.models.registry import fetch_model as jax_fetch_model
from hands_tpu_torch.cli import export as ex
from hands_tpu_torch.config import default_config
from hands_tpu_torch.models.backbones.vit import Block
from hands_tpu_torch.models.registry import fetch_model
from hands_tpu_torch.ops import attention as at
from hands_tpu_torch.ops import cuda_build
from hands_tpu_torch.ops import mano_lbs
from hands_tpu_torch.ops import vit_block as vb
from hands_tpu_torch.ops import vit_block_int8 as v8
from hands_tpu_torch.ops.library import OPS, graph_ops
from hands_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_hands_light import RTOL, fill_variables, max_rel

ARCTIC = dict(backbone="resnet18", compute_dtype="float32",
              use_render_seg_loss=False, use_grasp_loss=False)
RAW_HW = (64, 48)
CLI = ["--method", "arctic_sf_light", "--backbone", "resnet18", "--dtype",
       "float32", "--batch_size", "2", "--raw_hw", "64x48", "--device", "cpu"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def arctic(tmp_path_factory):
    """ArcticSF with numpy-drawn weights shared by both packages, written as
    a checkpoint that ``cli.export --ckpt`` serves. Holds the artifact's
    path, its outputs on the example batch (loaded and run), the live serving
    module's outputs, and the JAX model with its variables."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("export")
    cfg = default_config("arctic_sf_light", **ARCTIC)
    raw = ex.example_raw_batch(cfg, 2, RAW_HW)
    jcfg = jax_config("arctic_sf_light", **ARCTIC)
    jmodel = jax_fetch_model(jcfg)
    jraw = {k: jnp.asarray(v.numpy()) for k, v in raw.items()}
    inputs0, _, meta0 = JaxPre(jcfg, is_train=False)._process(
        jraw, jax.random.PRNGKey(0))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), inputs0, meta0))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, 1))
    model = fetch_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    ckpt = str(root / "last")
    torch.save({"model": model.state_dict()}, ckpt)
    art = str(root / "serving.pt2")
    assert ex.main(CLI + ["--ckpt", ckpt, "-o", art]) == 0
    run, sidecar = ex.load_artifact(art)
    with torch.no_grad():
        live = ex.build_serving_fn(cfg, model)(raw)
        out = run(raw)
    return dict(path=art, ckpt=ckpt, out=out, live=live, raw=raw,
                sidecar=sidecar, jax=(jcfg, jmodel, variables, jraw))


def test_export_round_trip(arctic):
    """Saved, loaded and run, the program equals live serving."""
    close(arctic["out"], arctic["live"], 1e-6)
    spec = arctic["sidecar"]["input_spec"]
    assert {k: tuple(v["shape"]) for k, v in spec.items()} == {
        k: tuple(v.shape) for k, v in arctic["raw"].items()}


def test_cpu_artifact_matches_jax_export(arctic):
    jcfg, jmodel, variables, jraw = arctic["jax"]
    ref = jax.jit(jax_serving_fn(jcfg, jmodel, variables))(jraw)
    worst, per_key = max_rel(dict(ref), arctic["out"], per_tensor=True)
    assert worst <= RTOL, per_key


def test_export_cli_smoke(arctic, capsys):
    sidecar = arctic["sidecar"]
    assert {"method", "batch_size", "raw_hw", "device", "dtype",
            "fused_block", "quant_int8", "fast_gelu", "ckpt", "weights_file",
            "input_spec", "output_keys", "kernels"} <= set(sidecar)
    assert sidecar["device"] == "cpu" and sidecar["weights_file"] == ""
    assert sidecar["batch_size"] == 2 and sidecar["ckpt"] == arctic["ckpt"]
    assert sidecar["kernels"] == {} and "twins" in sidecar["kernels_note"]
    assert sidecar["kernel_operands"] == []
    assert sidecar["input_spec"]["image"] == {"shape": [2, 64, 48, 3],
                                              "dtype": "uint8"}
    assert sorted(arctic["out"]) == sidecar["output_keys"]
    assert any("joints3d" in k for k in sidecar["output_keys"])
    capsys.readouterr()
    assert ex.main(["--run", arctic["path"]]) == 0
    assert "finite=True" in capsys.readouterr().out


def test_export_params_args_round_trip(arctic, tmp_path):
    """The CLI in args mode: the state goes to the weights file and the
    program file holds none of it; loaded and run with that state, the
    program equals live serving."""
    art = str(tmp_path / "serving.pt2")
    assert ex.main(CLI + ["--ckpt", arctic["ckpt"], "-o", art,
                          "--params_args"]) == 0
    sidecar = json.loads((tmp_path / "serving.pt2.json").read_text())
    assert sidecar["weights_file"] == "serving.pt2.weights.pt"
    weights = tmp_path / sidecar["weights_file"]
    assert weights.stat().st_size > 1e6
    baked = os.path.getsize(arctic["path"])
    assert os.path.getsize(art) < baked / 10  # the weights are not in it
    run, _ = ex.load_artifact(art)
    with torch.no_grad():
        close(run(arctic["raw"]), arctic["live"], 1e-6)


def test_vit_depth_needs_a_vit(tmp_path):
    """``--vit_depth`` cuts a ViT's blocks; a model without one refuses it
    before anything is exported."""
    with pytest.raises(ValueError, match="has no ViT"):
        ex.main(CLI + ["--vit_depth", "2", "-o", str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()


def test_cuda_export_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the export would run")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ex.main(CLI[:-2] + ["--device", "cuda", "-o",
                            str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()


def test_cuda_package_without_a_card_raises(tmp_path):
    """``--aoti --device cuda`` raises before it builds or writes
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the export would run")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ex.main(CLI[:-2] + ["--device", "cuda", "--aoti", "-o",
                            str(tmp_path / "x.pt2")])
    assert list(tmp_path.iterdir()) == []


# ----------------------------------------------------------- op shapes
def _draw(seed=0):
    g = torch.Generator().manual_seed(seed)

    def t(*shape, dtype=torch.float32, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(dtype)

    return t


def _op_cases():
    """op name, its arguments (CPU tensors), its plain twin's call."""
    t = _draw()
    bf, i8 = torch.bfloat16, torch.int8
    R, C, H, N, B, V = 12, 32, 2, 6, 2, 20
    x, s, b = t(R, C, dtype=bf), t(C, lo=0.5), t(C)
    qkv = t(B, N, 3 * C, dtype=bf)
    cases = [
        ("vit_layernorm", (x, s, b, 1e-6),
         lambda: vb.layernorm_plain(x, s, b, 1e-6)),
        ("vit_attention", (qkv, H), lambda: vb.attention_plain(qkv, H)),
        ("i8_ln_quant_dynamic", (x, s, b, 1e-6),
         lambda: v8.ln_quant_plain(x, s, b, True)),
        ("i8_ln_quant_static", (x.float(), s, b, 1e-6),
         lambda: v8.ln_quant_plain(x.float(), s, b, False)[0]),
        ("i8_quant_rows", (x,), lambda: v8.quant_rows_plain(x)),
        ("qkv_attention", (qkv, H, None),
         lambda: at.qkv_attention_plain(qkv, H)),
        ("qkv_attention", (qkv, H, t(C, lo=10, hi=20)),
         lambda: at.qkv_attention_plain(qkv, H, t(C, lo=10, hi=20))),
    ]
    w = t(2 * C, C, dtype=bf)
    for epi, code in vb._EPILOGUES.items():
        res = t(R, 2 * C, dtype=bf) if epi == "residual" else None
        cases.append((
            "vit_gemm", (x, w, t(2 * C, dtype=bf), res, code),
            lambda epi=epi, res=res: vb.gemm_plain(
                x, w, t(2 * C, dtype=bf), epi, res)))
    a_q = (t(R, C) * 100).to(i8)
    w_q = (t(2 * C, C) * 100).to(i8)
    for (dynamic, epi, dtype), mode in v8._GEMM_MODES.items():
        rs = t(R, 1, lo=0.01, hi=0.02) if dynamic else None
        res = (t(R, 2 * C, dtype=torch.float32 if dynamic else bf)
               if epi == "residual" else None)
        inv = t(2 * C, lo=10, hi=20) if mode == 6 else None
        cs, bias = t(2 * C, lo=1e-3, hi=2e-3), t(2 * C)
        cases.append((
            "i8_gemm", (a_q, w_q, cs, bias, rs, res, inv, mode, False),
            lambda rs=rs, res=res, inv=inv, epi=epi, dtype=dtype, cs=cs,
            bias=bias: v8.gemm_i8_plain(
                a_q, w_q, cs, bias, row_scale=rs, epilogue=epi, residual=res,
                inv_next=inv, out_dtype=dtype)))
    vp, W, A = t(B, V, 3), t(V, 16, lo=0, hi=1), t(B, 16, 4, 4)
    cases.append(("lbs_apply", (vp, W, A),
                  lambda: mano_lbs.lbs_apply_plain(vp, W, A)))
    return cases


CASES = _op_cases()


def test_every_serving_kernel_is_an_op():
    assert {name for name, _, _ in CASES} == {
        n.split("::")[1] for n in OPS}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_fake_function_matches_twin(case):
    name, args, plain = CASES[case]
    with FakeTensorMode():
        fake_args = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                     if torch.is_tensor(a) else a for a in args]
        got = getattr(torch.ops.hands_tpu_torch, name)(*fake_args)
    want = plain()
    got, want = ((got,), (want,)) if torch.is_tensor(want) else (got, want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


# ----------------------------------------------------- a block exported
ROUTES = {
    "K3": ({}, {"vit_layernorm": 2, "vit_gemm": 4, "vit_attention": 1}),
    "K5": ({"quant_int8": True},
           {"i8_ln_quant_dynamic": 2, "i8_quant_rows": 2, "i8_gemm": 4,
            "qkv_attention": 1}),
    "K6": ({"quant_int8": True, "quant_static": True, "fast_gelu": True},
           {"i8_ln_quant_static": 2, "i8_gemm": 4, "qkv_attention": 1}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_block_exports_its_kernel_ops(route):
    """A bf16 ``fused_block`` block on fake CUDA tensors: the graph holds
    that block's kernels as ops, and nothing traced touches storage. The
    int8 operands are prepared on a CPU twin of the block (preparing needs
    CUDA support for fake CUDA tensors) and handed over as fake tensors of
    their shapes."""
    kw, want = ROUTES[route]
    block_kw = dict(dim=64, num_heads=2, mlp_ratio=2.0, dtype=torch.bfloat16,
                    fused_block=True, **kw)
    ops = Block(**block_kw).prepared() if "quant_int8" in kw else None
    seen = []
    with FakeTensorMode():
        block = Block(device="cuda", **block_kw)
        if ops is not None:
            block._prepared = {k: torch.empty(v.shape, dtype=v.dtype,
                                              device="cuda")
                               for k, v in ops.items()}
        x = torch.empty(2, 5, 64, dtype=torch.bfloat16, device="cuda")

    def spy(module, args):
        seen.append((torch.compiler.is_exporting(),
                     torch.compiler.is_compiling(), cuda_build.tracing()))

    block.register_forward_pre_hook(spy)
    with torch.no_grad(), ex.kernel_state(block) as operands:
        program = torch.export.export(block, (x,), strict=False)
    assert seen == [(True, True, True)]  # both flags are set under export
    assert graph_ops(program.graph) == {
        f"hands_tpu_torch::{k}": n for k, n in sorted(want.items())}
    state = set(program.state_dict)
    if ops is None:
        assert operands == [] and len(state) == 12
    else:  # the prepared operands, under their names, and nothing else
        assert operands == sorted(f"int8_operands.{k}" for k in ops)
        assert state == set(operands)
    assert not hasattr(block, "int8_operands")  # released after the export
    assert len(dict(block.named_parameters())) == 12 + (
        4 if "quant_static" in kw else 0)
