"""The port's ``Experiment`` and profiling hooks (``hands_tpu_torch.utils``)
against the JAX package's: experiment keys, directories, ``args.json``,
``metrics.jsonl`` lines, the step tracer's Chrome trace."""

import json
import os

import torch

from hands_tpu.config import default_config as jax_config
from hands_tpu.utils import experiment as jexp
from hands_tpu_torch.config import default_config
from hands_tpu_torch.utils import experiment as texp
from hands_tpu_torch.utils import profiling


def test_exp_keys():
    key = texp.generate_exp_key()
    assert len(key) == 9 and int(key, 16) >= 0
    assert key != texp.generate_exp_key()
    for path in ("logs/abc123def/checkpoints/last",
                 "/data/run/logs/0f0f0f0f0/checkpoints/epoch_0003",
                 "checkpoints/last", "logs", ""):
        assert texp.exp_key_from_ckpt_path(path) == \
            jexp.exp_key_from_ckpt_path(path), path
    assert texp.exp_key_from_ckpt_path(
        "logs/abc123def/checkpoints/last") == "abc123def"


def test_experiment_files_match_jax(tmp_path):
    kw = dict(logger="none", exp_key="")
    tcfg = default_config("hands_light", **kw)
    jcfg = jax_config("hands_light", **kw)
    te = texp.Experiment(tcfg, root=str(tmp_path / "t" / "logs"))
    je = jexp.Experiment(jcfg, root=str(tmp_path / "j" / "logs"))
    assert len(te.key) == 9 and te.ckpt_dir == os.path.join(te.dir,
                                                            "checkpoints")
    assert os.path.isdir(te.ckpt_dir)
    for exp in (te, je):
        exp.log_dict({"loss": 1.5, "loss/mano/pose/r": 0.25}, 7,
                     postfix="__train")
        exp.log_dict({"epoch_time_s": 2.0}, 7)
        exp.push_images([], 7)  # no TensorBoard: a no-op
        exp.close()

    def lines(exp):
        rows = [json.loads(ln) for ln in
                open(os.path.join(exp.dir, "metrics.jsonl"))]
        for r in rows:
            assert r.pop("time") > 0
        return rows

    assert lines(te) == lines(je) == [
        {"loss__train": 1.5, "loss/mano/pose/r__train": 0.25, "step": 7},
        {"epoch_time_s": 2.0, "step": 7}]
    targs = json.load(open(os.path.join(te.dir, "args.json")))
    jargs = json.load(open(os.path.join(je.dir, "args.json")))
    assert set(targs) == set(jargs)
    assert targs["method"] == "hands_light" and targs["lr"] == jargs["lr"]


def test_experiment_reuses_the_key_of_a_checkpoint_path(tmp_path):
    root = str(tmp_path / "logs")
    first = texp.Experiment(default_config("hands_light", logger="none"),
                            root=root)
    first.log_dict({"loss": 1.0}, 1)
    first.close()
    resume = default_config(
        "hands_light", logger="none",
        resume_ckpt=os.path.join("logs", first.key, "checkpoints", "last"))
    second = texp.Experiment(resume, root=root)
    assert second.key == first.key and second.dir == first.dir
    second.log_dict({"loss": 0.5}, 2)
    second.close()  # appended, not truncated
    assert len(open(os.path.join(first.dir, "metrics.jsonl")).readlines()) == 2
    named = texp.Experiment(default_config("hands_light", logger="none",
                                           exp_key="myrun"), root=root)
    assert named.key == "myrun"
    named.close()


def test_step_trace_and_timer(tmp_path):
    tracer = profiling.StepTrace(str(tmp_path / "trace"), steps=2, skip=1)
    for step in range(5):
        tracer.update(step)
        with profiling.annotate("toy_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    tracer.close()
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "toy_step" in names
    off = profiling.StepTrace(str(tmp_path / "none"), steps=0)
    off.update(0)
    off.close()
    assert not os.path.exists(tmp_path / "none")
    with profiling.trace(str(tmp_path / "ctx")) as prof:
        torch.ones(8).sum()
    assert os.path.exists(tmp_path / "ctx" / "trace.json")
    assert len(prof.key_averages()) > 0
    timer = profiling.StepTimer(warmup=1)
    for _ in range(4):
        timer.start()
        timer.stop(torch.ones(2))
    s = timer.summary()
    assert s["steps"] == 3 and s["max_ms"] >= s["p50_ms"] >= 0
    assert profiling.StepTimer().summary() == {}
