"""The port never imports JAX, nor anything of the JAX package: the machine
with the card has neither.

In a fresh interpreter (the test process itself has JAX loaded), import
every module of ``hands_tpu_torch``, build tiny HaMeR on the CPU, serve one
bf16 and one int8 request, run the WildHands evaluation forward (ResNet-18,
render and grasp on) and its int8 serving, take a train step and an eval step
with each model family on a synthetic batch (K4's Function, BatchNorm in
train mode, dropout from a generator, the optimiser, the metrics), time the
nine modes of the int8 block ablation on a small probe, run the
model-parallel axes on a mesh of this process alone (``Mesh.alone``: both
sequence-parallel attentions, the pipeline, a tensor-parallel and a ringed
tiny ViT against the plain one), run a ``--debug``
epoch through ``cli.train`` (train-mode preprocessing, the prefetching loader,
the trainer, checkpoints, the experiment log), draw the overlays of a served
batch (without matplotlib, which the card's machine lacks), pack synthetic
records through
``cli.pack_records`` and load them with ``pcl`` preprocessing, time two rows
of ``cli.train_decompose``, and check that neither ``jax``, ``flax``,
``optax`` nor ``hands_tpu`` was imported
along the way. A second test reads the sources:
no import line of the port or of ``chip_smoke.py`` names them.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
import numpy as np
import torch
import importlib
import pkgutil
import hands_tpu_torch
for m in pkgutil.walk_packages(hands_tpu_torch.__path__, "hands_tpu_torch."):
    importlib.import_module(m.name)
from hands_tpu_torch.cli.demo import make_record, serve, serving_config
from hands_tpu_torch.models.registry import fetch_model

rng = np.random.RandomState(0)
recs = [make_record(f"r{i}", rng.randint(0, 256, (200, 240, 3), np.uint8),
                    np.asarray([20.5, 30.5, 150.5, 170.5], np.float32), None)
        for i in range(2)]
cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
out = serve(recs, cfg, fetch_model(cfg, "cpu", seed=0, vit_variant="tiny"),
            "cpu")
assert out["pred.mano.vertices.r"].shape == (2, 778, 3)
assert torch.isfinite(out["pred.mano.j3d.cam.l"]).all()
cfg8 = serving_config("hamer_light", "bfloat16", quant_int8=True)
out8 = serve(recs, cfg8, fetch_model(cfg8, "cpu", seed=0, vit_variant="tiny"),
             "cpu")
assert torch.isfinite(out8["pred.mano.vertices.r"]).all()
drift = (out8["pred.mano.vertices.r"] - out["pred.mano.vertices.r"]).abs()
assert 0 < float(drift.max()) < 0.1, float(drift.max())
from hands_tpu_torch.config import default_config
for name in ("core.transforms", "core.thing", "models.backbones.resnet",
             "models.heads.hmr", "models.hands_light", "ops.mano_lbs",
             "ops.rasterizer"):
    assert f"hands_tpu_torch.{name}" in sys.modules, name
cfgw = default_config("hands_light", backbone="resnet18")
assert cfgw.use_render_seg_loss and cfgw.use_grasp_loss
outw = serve(recs, cfgw, fetch_model(cfgw, "cpu", seed=0), "cpu")
assert outw["pred.render.r"].shape == (2, 224, 224)
assert outw["pred.grasp.l"].shape == (2, 9)
assert torch.isfinite(outw["pred.mano.vertices.r"]).all()
from hands_tpu_torch.utils.vis import visualize_all
figures = visualize_all(outw, cfgw, max_examples=1)
assert [n for n, _ in figures] == ["0__pred_kps",
                                   "0__rend_rvalid=1, lvalid=1"]
cfgq = serving_config("hands_light", "float32", quant_int8=True).replace(
    backbone="resnet18")
outq = serve(recs, cfgq, fetch_model(cfgq, "cpu", seed=0), "cpu")
assert torch.isfinite(outq["pred.mano.vertices.l"]).all()
from hands_tpu_torch.data.synthetic import make_batch
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.train.step import make_eval_step, make_train_step
for name in ("train.losses", "train.metrics", "train.process", "train.state",
             "train.step", "ops.procrustes", "data.synthetic"):
    assert f"hands_tpu_torch.{name}" in sys.modules, name
size = dict(img_res=160, img_res_ds=160)
for cfgt, kw in ((default_config("hamer_light", fused_block=True, **size),
                  dict(vit_variant="tiny", param_dtype=torch.float32)),
                 (default_config("hands_light", backbone="resnet18", **size),
                  {})):
    assert cfgt.compute_dtype == "bfloat16" and cfgt.use_render_seg_loss
    modelt = fetch_model(cfgt, "cpu", seed=0, **kw)
    batch = make_batch(cfgt, 2, seed=0, device="cpu")
    state = create_train_state(cfgt, modelt)
    state, logs = make_train_step(modelt, cfgt)(
        state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and torch.isfinite(logs["loss"]), cfgt.method
    assert float(logs["grad_norm"]) > 0 and "loss/mask/r" in logs
    metrics, elogs = make_eval_step(modelt, cfgt)(state, batch)
    assert torch.isfinite(metrics["mpjpe/pa/ra/h"]).all(), cfgt.method
    assert torch.isfinite(elogs["loss"]) and not modelt.training
from hands_tpu_torch.cli import int8_ablation
times = int8_ablation.run_ablation(
    iters=1, device="cpu", heads=2, out=lambda line: None,
    probe=int8_ablation.make_probe(1, "cpu", c=128, hidden=256, n_tok=12))
assert len(times) == 9 and all(v > 0 for v in times.values())
import os, tempfile
from hands_tpu_torch.cli import evaluate, train
small = dict(backbone="resnet18", compute_dtype="float32", img_res=160,
             img_res_ds=160, use_glb_feat=False, num_workers=2, batch_size=12,
             test_batch_size=6, eval_every_epoch=1, exp_key="run",
             # the TensorBoard writer is third-party code outside this guard:
             # with TensorFlow installed it imports JAX by itself
             logger="none")
with tempfile.TemporaryDirectory() as tmp:
    state = train.main(["--debug", "--device", "cpu", "--no_vis"],
                       log_root=tmp, overrides=small)
    assert state.step == 1 and not state.model.training
    last = os.path.join(tmp, "run", "checkpoints", "last")
    assert sorted(os.listdir(os.path.dirname(last))) == [
        "epoch_0000", "last", "scores.json"]
    assert callable(evaluate.main)  # run in tests/test_torch_trainer.py
from hands_tpu_torch.cli import pack_records, train_decompose
from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
from hands_tpu_torch.data.packed import PackedRecordDataset
with tempfile.TemporaryDirectory() as tmp:
    assert pack_records.main(["--synthetic", "3", "--out", tmp]) == 0
    cfgp = default_config("hands_light", pos_enc="pcl", img_res=64,
                          img_res_ds=64)
    loader = DeviceDataLoader(PackedRecordDataset(tmp), cfgp, 2, True,
                              drop_last=False, num_workers=0, device="cpu")
    (i1, _, m1), (i2, _, m2) = list(loader)
    assert i1["r_rot"].shape == (2, 3, 3) and m2["num_valid"] == 1
setup = train_decompose.Setup("hamer_light", 1, "cpu", vit="tiny",
                              img_res=64)
rows = train_decompose.measure(setup, 1, rows=["gt_process", "full_step"])
assert all(r["median"] > 0 for r in rows.values())
for name in ("ops.vit_block_ablation", "cli.int8_ablation", "cli.train",
             "cli.evaluate", "cli._args", "data.factory", "train.trainer",
             "train.checkpoint", "utils.experiment", "utils.profiling",
             "data.packed", "cli.pack_records", "cli.train_decompose",
             "data.dataset_utils", "utils.native", "cli.numerics_check",
             "cli.int8_accuracy"):
    assert f"hands_tpu_torch.{name}" in sys.modules, name
for name in ("utils.vis", "render.software", "core.object_tensors",
             "data.arctic_processing", "ops.smplx_body", "ops.knn",
             "train.metrics_object", "cli.sample_data", "cli.verify_setup"):
    assert f"hands_tpu_torch.{name}" in sys.modules, name
from hands_tpu_torch.models.backbones.vit import ViTBackbone
from hands_tpu_torch.models.registry import init_weights_
from hands_tpu_torch.parallel import pipeline, sequence, sharding
from hands_tpu_torch.parallel.mesh import Mesh
alone = Mesh.alone(("data", "model"), "cpu")  # the axes on one process
one = alone.axis("model")
q = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
want = sequence.mha_reference(q, q, q)
for fn in (sequence.sp_attention, sequence.ring_attention):
    assert torch.allclose(fn(q, q, q, one), want, atol=1e-6), fn.__name__
assert torch.equal(pipeline.pipeline_apply(lambda p, x: x * p, 2.0, q, one),
                   q * 2.0)
img = torch.rand(2, 64, 48, 3, generator=torch.Generator().manual_seed(1))
for kw, tol in ((dict(dtype=torch.bfloat16, fused_block=True), 3e-2),
                (dict(dtype=torch.float32, ring=alone), 1e-5)):
    bb = ViTBackbone("tiny", img_hw=(64, 48), **kw)
    init_weights_(bb, torch.Generator().manual_seed(2))
    ref = ViTBackbone("tiny", img_hw=(64, 48), dtype=kw["dtype"],
                      fused_block=kw.get("fused_block", False))
    ref.load_state_dict(bb.state_dict())
    if "ring" not in kw:
        sharding.shard_vit_tp(bb, one)
    with torch.no_grad():
        assert torch.allclose(bb(img), ref(img), atol=tol), kw
for name in ("parallel.mesh", "parallel.sharding", "parallel.sequence",
             "parallel.pipeline", "cli.parallel_check"):
    assert f"hands_tpu_torch.{name}" in sys.modules, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "hands_tpu"))
assert not bad, bad
# the card's machine has no matplotlib: the figures are drawn with PIL
assert "matplotlib" not in sys.modules
print("NOJAX_OK")
"""


def test_port_serves_without_importing_jax():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"  # six test workers run side by side
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def test_port_sources_name_no_jax_import():
    """No ``import``/``from`` line of the port or of ``chip_smoke.py`` names
    ``hands_tpu``, ``jax`` or ``flax`` (docstrings may mention them)."""
    pattern = re.compile(r"^\s*(from|import)\s+(hands_tpu|jax|jaxlib|flax|"
                         r"optax)(\.|\s|$)")
    files = sorted((REPO / "hands_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 55
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"hands_tpu_torch/train/step.py", "hands_tpu_torch/train/state.py",
            "hands_tpu_torch/data/synthetic.py",
            "hands_tpu_torch/ops/procrustes.py",
            "hands_tpu_torch/ops/vit_block_ablation.py",
            "hands_tpu_torch/cli/int8_ablation.py",
            "hands_tpu_torch/cli/train.py", "hands_tpu_torch/cli/evaluate.py",
            "hands_tpu_torch/cli/_args.py", "hands_tpu_torch/data/factory.py",
            "hands_tpu_torch/train/trainer.py",
            "hands_tpu_torch/train/checkpoint.py",
            "hands_tpu_torch/utils/experiment.py",
            "hands_tpu_torch/utils/profiling.py",
            "hands_tpu_torch/data/packed.py",
            "hands_tpu_torch/cli/pack_records.py",
            "hands_tpu_torch/cli/train_decompose.py",
            "hands_tpu_torch/data/dataset_utils.py",
            "hands_tpu_torch/utils/native.py",
            "hands_tpu_torch/cli/numerics_check.py",
            "hands_tpu_torch/cli/int8_accuracy.py",
            "hands_tpu_torch/utils/vis.py", "hands_tpu_torch/utils/viewer.py",
            "hands_tpu_torch/render/software.py",
            "hands_tpu_torch/core/object_tensors.py",
            "hands_tpu_torch/core/tree_utils.py",
            "hands_tpu_torch/core/mesh.py", "hands_tpu_torch/ops/knn.py",
            "hands_tpu_torch/ops/smplx_body.py",
            "hands_tpu_torch/train/process_object.py",
            "hands_tpu_torch/train/metrics_object.py",
            "hands_tpu_torch/data/arctic_processing.py",
            "hands_tpu_torch/cli/sample_data.py",
            "hands_tpu_torch/cli/verify_setup.py",
            "hands_tpu_torch/parallel/sharding.py",
            "hands_tpu_torch/parallel/sequence.py",
            "hands_tpu_torch/parallel/pipeline.py"} <= names
    bad = [f"{f.relative_to(REPO)}:{n}: {line.strip()}"
           for f in files
           for n, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad
