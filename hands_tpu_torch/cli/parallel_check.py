"""The parallel axes' runs held against their one-process counterparts.

    python -m hands_tpu_torch.cli.parallel_check --spec spec.json --out DIR \\
        --ranks 2 [--device cpu] [--timeout 900]

starts two ranks of itself on this host (``parallel/launch.py``; one group
through a free localhost port, by the backend rule of
``parallel/distributed.py``) and waits for them; without ``--ranks`` it runs
one rank, and ``--num_processes / --process_id / --coordinator_address`` are
those of ``cli.train``, which it shares: ``cli._args.parse`` brings the group
up, ``Trainer`` places the model (rank 0's values, FSDP's sharding) and
makes the steps, and the eval-mode loader takes each rank's rows of every
global batch. ``spec.json`` says what a rank runs:

- ``method``, ``vit_variant`` (``"h"``), ``overrides`` (``Config`` fields);
- ``weights``: a ``state_dict`` file, else the weights of ``cfg.seed``;
- ``batch``: a global batch written by :func:`save_batch` (every step takes
  it), else ``records`` synthetic records through the sharded eval loader,
  a global batch of ``cfg.batch_size`` a step;
- ``steps``: the steps held (two more run for ``device_busy_ms`` on the
  ranks unless ``profile`` is false);
- ``modes``: ``"ddp"`` (replicated parameters) and ``"fsdp"``, run one after
  the other, each on a model built afresh; ``"ddp_f64"`` and ``"fsdp_f64"``
  take instead the first step's loss and gradients with the model, the
  batch and every rounding in f64 (``utils/exact.py``; the optimiser keeps
  f32 masters, so nothing is updated): kinks (ReLU zeros, max-pool ties)
  that f32 rounding moves between two runs stay put there;
- the model axis (every rank one ``"model"`` coordinate of a (1, ranks)
  ``("data", "model")`` mesh): ``"tp"``, the train steps of ``make_train_step``
  on the model after ``parallel/sharding.py:shard_vit_tp``, every rank on the
  global batch (held to ``"reference"``); and three forward modes, each held
  to the one-process run named after it (``FORWARD``): ``"tp_serve"``
  (``cli.demo.serve`` of ``requests`` synthetic requests of ``images``
  images through the sharded bf16 ``fused_block`` model; ``"serve"``),
  ``"sp"`` (the plain ``ViTBackbone``, bf16 or ``sp_dtype``, with ``ring``
  on ``images`` random images, and ``sp_attention`` and ``ring_attention``
  in f32 at ``attention`` (B, N, H, D) against ``mha_reference``;
  ``"backbone"``, the same backbone on a ring of this process alone,
  ``Mesh.alone``: the ring's attention is f32 where the plain bf16 block
  rounds its logits to bf16, so the counterpart takes the same arithmetic
  unsharded),
  ``"pp"`` (``pipeline_apply`` over the ranks' equal groups of the bf16
  ``fused_block`` blocks, ``microbatches`` of ``images`` crops of tokens;
  ``"serial"``, every block in turn on each microbatch);
- ``reference``: rank 0 then runs the one-process step
  (``make_train_step`` without ranks) on the global batches; a list names
  the one-process runs (``"reference"``, a forward mode's counterpart) and
  may add ``"split"``, the one-process step that takes the global batch in as
  many row blocks as there are ranks and averages their gradients
  (:func:`split_step`: the ranks' arithmetic without ranks, for models
  without BatchNorm);
- ``vit_depth``: the ViT's first blocks only (widths stay); ``mode_depth``
  {mode: depth} the same for one mode;
- ``images`` (each request of ``"tp_serve"``), ``sp_images``, ``pp_crops``
  (a microbatch), ``requests``, ``microbatches``, ``attention``: the
  forward modes' sizes;
- ``save``: rank 0 writes each mode's tensors there (``torch.save``),
  the first Adam moment included.

Each rank writes ``DIR/rank<r>.json``: per mode the loss terms and
``grad_norm`` of each held step; of the last held step its host ms, the
host ms inside collectives and their waits (:class:`CommClock`) and its
kernel launches; the card's busy ms of a step (``device_busy_ms``); the
memory held after the held steps and the peak; and the bytes of parameters
the rank holds against the whole model. Rank 0 adds ``compare``:
loss and ``grad_norm`` against each one-process run, step by step
(relative); the
first step's gradients and the parameters after the held steps, leaf by
leaf, against each one-process run and FSDP against DDP (the worst leaf's
largest and mean distance over its largest entry), and for FSDP against
DDP the share of parameter entries more than half a learning rate apart (Adam moves an entry by about
the learning rate whatever its gradient, so where a gradient is near zero
the two runs may step apart by that much: read against its largest entry,
a bias that starts at zero shows such an entry as a distance of order one;
a shard whose update went astray moves every entry); and the largest
distance between the ranks' BatchNorm running statistics. A forward mode
reports its ms a call (the last held one), the host ms in collectives, the
device ms of a call, the all-reduces of the model axis a call and the
memory, and rank 0 compares its outputs with the one-process run's (the
largest and the mean distance over max(|ref|, 1), and whether they are
bit-equal). The numbers are reported, not judged: ``chip_smoke.py`` and
``tests/test_torch_multiprocess.py`` hold them to their limits.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

PARTS = ("inputs", "targets", "meta")
# a forward mode -> the one-process run it is held to
FORWARD = {"tp_serve": "serve", "sp": "backbone", "pp": "serial"}


def save_batch(path: str, batch) -> None:
    """A numpy (inputs, targets, meta) batch -> one ``.npz`` file."""
    flat = {f"{part}/{k}": np.asarray(v)
            for part, d in zip(PARTS, batch) for k, v in d.items()}
    np.savez(path, **flat)


def load_batch(path: str, device):
    """The batch of :func:`save_batch` as port ``XDict``s on ``device``
    (string arrays stay lists)."""
    from hands_tpu_torch.core.xdict import XDict

    out = [XDict() for _ in PARTS]
    with np.load(path) as f:
        for key in f.files:
            part, name = key.split("/", 1)
            arr = f[key]
            out[PARTS.index(part)][name] = (
                arr.tolist() if arr.dtype.kind in "US"
                else torch.from_numpy(np.array(arr)).to(device))
    return tuple(out)


def launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of the port, by name."""
    from hands_tpu_torch.ops import attention, mano_lbs, rasterizer
    from hands_tpu_torch.ops import vit_block as vb

    from hands_tpu_torch.parallel import sharding

    out = {f"vit_{k}": v for k, v in vb.launches.items()}
    out.update(vb.bwd_launches)
    for mod in (attention, mano_lbs, rasterizer):
        out.update(mod.launches)
    out["model_all_reduce"] = sharding.all_reduces["n"]
    return out


class CommClock:
    """Host seconds spent inside ``torch.distributed``'s collectives and in
    the waits on their handles, while installed. FSDP2 calls the same
    module functions (whichever of the names this torch has), so its
    gathers and scatters count too; an async call's handle is a ``Work``
    whose ``wait`` is timed."""

    NAMES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "all_gather_single", "reduce_scatter_tensor",
             "reduce_scatter_single", "barrier", "all_gather_object",
             "broadcast_object_list")

    def __init__(self):
        import torch.distributed as dist

        self.seconds = 0.0
        self._dist = dist
        self._saved = {n: getattr(dist, n) for n in self.NAMES
                       if hasattr(dist, n)}
        for name, fn in self._saved.items():
            setattr(dist, name, self._timed(fn))

    def _timed(self, fn):
        clock = self
        Work = self._dist.distributed_c10d.Work

        class Timed(Work):  # an async collective's handle, its wait timed
            def __init__(self, work):
                super().__init__()
                self.work = work

            def wait(self, *args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return self.work.wait(*args, **kwargs)
                finally:
                    clock.seconds += time.perf_counter() - t0

            def is_completed(self):
                return self.work.is_completed()

            def get_future(self):
                return self.work.get_future()

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                clock.seconds += time.perf_counter() - t0
            return Timed(out) if isinstance(out, Work) else out

        return call

    def close(self) -> None:
        for name, fn in self._saved.items():
            setattr(self._dist, name, fn)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _worst(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """(leaf, max, mean) of the leaf farthest from ``ref``, each distance
    over the leaf's largest ``ref`` entry."""
    worst = ("", 0.0, 0.0)
    for name, r in ref.items():
        r = r.double()
        d = (got[name].double() - r).abs()
        scale = max(float(r.abs().max()), 1e-12)
        mx, mean = float(d.max()) / scale, float(d.mean()) / scale
        if not np.isfinite(mx) or mx > worst[1]:
            worst = (name, mx, mean)
    return worst


def _apart(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           step: float) -> float:
    """The share of entries farther apart than ``step``."""
    n = sum(int(((got[k].double() - r.double()).abs() > step).sum())
            for k, r in ref.items())
    return n / max(sum(r.numel() for r in ref.values()), 1)


def split_step(model, cfg, parts: int):
    """The one-process train step that takes the global batch in ``parts``
    row blocks, as many ranks would: each block's loss and gradients, their
    sums times 1/``parts`` (the ranks' all-reduce), then the update. Equal
    to the ranks' step for a model without BatchNorm in train mode (which
    would see each block's moments) and without dropout (HaMeR)."""
    from hands_tpu_torch.core.precision import f32_matmuls
    from hands_tpu_torch.parallel.mesh import shard_batch
    from hands_tpu_torch.train.step import _logs, loss_and_grads

    @f32_matmuls
    def step(state, batch, generator=None):
        sums, logs = None, None
        for r in range(parts):
            total, loss_dict, grads = loss_and_grads(
                model, cfg, state.tx.model_params,
                shard_batch(batch, r, parts), generator)
            part = {k: v.float() for k, v in _logs(total, loss_dict).items()}
            sums = grads if sums is None else [
                a + b for a, b in zip(sums, grads)]
            logs = part if logs is None else {
                k: logs[k] + part[k] for k in logs}
        grads = [g.mul_(1.0 / parts) for g in sums]
        logs = {k: v * (1.0 / parts) for k, v in logs.items()}
        logs["grad_norm"] = state.tx.grad_norm(grads)
        return state.apply_gradients(grads), logs

    return step


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _out_distance(got: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor]) -> dict:
    """A forward mode's outputs against the one-process run's: the worst
    output's largest and mean distance over max(|ref|, 1), and whether all
    are bit-equal."""
    worst, equal = ("", 0.0, 0.0), True
    for name, r in ref.items():
        g = got[name]
        equal = equal and torch.equal(g, r)
        d = (g.double() - r.double()).abs()
        scale = max(float(r.double().abs().max()), 1.0)
        mx, mean = float(d.max()) / scale, float(d.mean()) / scale
        if not np.isfinite(mx) or mx > worst[1]:
            worst = (name, mx, mean)
    return {"worst": worst[0], "max": worst[1], "mean": worst[2],
            "equal": equal}


class _Rank:
    def __init__(self, argv: List[str], spec: dict, out_dir: str):
        from hands_tpu_torch.cli._args import parse
        from hands_tpu_torch.parallel.distributed import data_group

        self.cfg, self.device = parse(["--method", spec["method"]] + argv)
        self.cfg = self.cfg.replace(**spec.get("overrides", {}))
        self.spec = spec
        self.out_dir = out_dir
        self.dp = data_group()
        self.rank = 0 if self.dp is None else self.dp.rank
        self.world = 1 if self.dp is None else self.dp.world
        self.steps = int(spec.get("steps", 2))
        self._mesh = None

    def model_axis(self):
        """This rank's line of the ``"model"`` axis of a (1, ranks)
        ``("data", "model")`` mesh (made once: every rank calls)."""
        from hands_tpu_torch.parallel.mesh import make_mesh

        if self._mesh is None:
            self._mesh = make_mesh((1, self.world), ("data", "model"),
                                   torch.device(self.device).type)
        return self._mesh.axis("model")

    # ------------------------------------------------------------ inputs
    def model(self, mode: str = ""):
        from hands_tpu_torch.models.registry import fetch_model

        model = fetch_model(self.cfg, self.device, seed=self.cfg.seed,
                            vit_variant=self.spec.get("vit_variant", "h"),
                            param_dtype=torch.float32)
        self.cut_depth(model, mode)
        if self.spec.get("weights"):
            model.load_state_dict(torch.load(
                self.spec["weights"], map_location=self.device,
                weights_only=True))
        return model

    def cut_depth(self, model, mode: str) -> None:
        """The ViT's first ``vit_depth`` (or ``mode_depth[mode]``) blocks
        only (widths stay); ``model`` a ViT backbone or a HaMeR model."""
        depth = self.spec.get("mode_depth", {}).get(
            mode, self.spec.get("vit_depth"))
        if depth:
            bb = getattr(getattr(model, "net", None), "backbone", model)
            bb.blocks = bb.blocks[:int(depth)]

    def batches(self, sharded: bool) -> list:
        """The batches of the held steps and the two profiled ones: this
        rank's rows, or (``sharded`` false) the global batches."""
        from hands_tpu_torch.core.xdict import device_view
        from hands_tpu_torch.data.datasets import SyntheticRecordDataset
        from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
        from hands_tpu_torch.parallel.mesh import shard_batch

        n = self.steps + 2
        shard = (self.rank, self.world) if sharded else (0, 1)
        if self.spec.get("batch"):
            batch = load_batch(self.spec["batch"], self.device)
            return [shard_batch(batch, *shard)] * n
        dataset = SyntheticRecordDataset(self.cfg, "train",
                                         length=int(self.spec["records"]))
        loader = DeviceDataLoader(dataset, self.cfg, self.cfg.batch_size,
                                  is_train=False, num_workers=0,
                                  shard=shard, device=self.device)
        out = []
        while len(out) < n:
            out += [(i, t, device_view(m)) for i, t, m in loader]
        return out[:n]

    # -------------------------------------------------------------- steps
    def run(self, mode: str) -> dict:
        """One mode's steps; returns (summary, tensors kept on rank 0)."""
        from hands_tpu_torch.parallel import fsdp
        from hands_tpu_torch.train.state import create_train_state
        from hands_tpu_torch.train.step import make_train_step
        from hands_tpu_torch.train.trainer import Trainer
        from hands_tpu_torch.utils.experiment import Experiment
        from hands_tpu_torch.utils.profiling import device_busy_ms

        from hands_tpu_torch.parallel import sharding

        print(f"rank {self.rank}: {mode}", flush=True)
        if mode.endswith("_f64"):
            return self.run_f64(mode[:-len("_f64")])
        if mode in FORWARD or mode in FORWARD.values():
            return self.run_forward(mode)
        model = self.model(mode)
        total_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        if mode == "tp":  # the model ranks' shards, every rank all rows
            sharding.shard_vit_tp(model, self.model_axis())
            state = create_train_state(self.cfg, model)
            step = make_train_step(model, self.cfg)
            batches = self.batches(sharded=False)
        elif mode in ("reference", "split"):  # one process, the global batch
            state = create_train_state(self.cfg, model)
            step = (make_train_step(model, self.cfg) if mode == "reference"
                    else split_step(model, self.cfg, self.world))
            batches = self.batches(sharded=False)
        else:
            cfg = self.cfg.replace(fsdp=mode == "fsdp", logger="none",
                                   mute=True)
            exp = Experiment(cfg, root=os.path.join(self.out_dir, "logs"))
            trainer = Trainer(cfg, model, exp)
            state, _ = trainer.init_state()
            step = trainer.train_step
            batches = self.batches(sharded=True)
        names = [n for n, _ in model.named_parameters()]
        first_grads: List[torch.Tensor] = []
        apply = state.apply_gradients

        def spy(grads):
            if not first_grads:
                first_grads.extend(g.detach().clone() for g in grads)
            return apply(grads)

        state.apply_gradients = spy
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        if torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        logs, host_ms, launches = [], 0.0, {}
        clock = CommClock() if self.dp is not None else None
        try:
            for i in range(self.steps):
                print(f"rank {self.rank}: {mode} step {i + 1}", flush=True)
                _sync(self.device)
                before = launch_counts()
                if clock is not None:
                    clock.seconds = 0.0
                t0 = time.perf_counter()
                state, step_logs = step(state, batches[i], gen)
                _sync(self.device)
                host_ms = 1e3 * (time.perf_counter() - t0)
                comm_ms = 0.0 if clock is None else 1e3 * clock.seconds
                launches = {k: v - before[k]
                            for k, v in launch_counts().items()
                            if v != before[k]}
                logs.append({k: float(v) for k, v in step_logs.items()})
        finally:
            if clock is not None:
                clock.close()

        params = dict(zip(names, state.tx.model_params))
        keep = self.rank == 0 or mode in ("reference", "split")

        def whole(tensors):  # every rank takes part; rank 0 keeps
            out = {n: fsdp.full(sharding.full_tp(t, params[n]), params[n])
                   for n, t in tensors}
            return {n: t.detach().to("cpu", copy=True)
                    for n, t in out.items()} if keep else {}

        tensors = {
            "grads": whole(zip(names, first_grads)),
            "params": whole((n, fsdp.local(p)) for n, p in params.items()),
            "mu": (whole(zip(names, state.tx.mu)) if self.spec.get("save")
                   else {}),
            "buffers": {n: b.detach().to("cpu", copy=True)
                        for n, b in model.named_buffers()},
            "logs": logs,
        }
        cuda = torch.device(self.device).type == "cuda"
        held_gb = torch.cuda.memory_allocated() / 2 ** 30 if cuda else None
        device_ms = None
        if self.spec.get("profile", True) and mode not in ("reference",
                                                           "split"):
            steps = iter(batches[self.steps:])
            device_ms = device_busy_ms(
                lambda: step(state, next(steps), gen))[0]
        summary = {
            "logs": logs, "step_ms": host_ms, "device_ms": device_ms,
            "collective_ms": comm_ms,
            "held_gb": held_gb,
            "peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if cuda else None),
            "launches": launches,
            "shard_bytes": fsdp.shard_bytes(state.tx.model_params),
            "total_bytes": total_bytes,
        }
        # the spy closes a cycle through the state: collect it, so that the
        # next mode's peak does not count this one's tensors
        del state, model, step, batches, first_grads, params, spy
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return summary, tensors

    def forward_calls(self, mode: str):
        """A forward mode's (or its counterpart's) model and its calls: (the
        module whose parameters it holds, [a closure a held call, each
        returning {name: tensor}], extra numbers for the summary)."""
        from hands_tpu_torch.cli.demo import serve, serving_config
        from hands_tpu_torch.core.precision import f32_exact
        from hands_tpu_torch.data.datasets import SyntheticRecordDataset
        from hands_tpu_torch.models.backbones.vit import IMG_HW, ViTBackbone
        from hands_tpu_torch.models.registry import fetch_model, init_weights_
        from hands_tpu_torch.parallel import sequence, sharding
        from hands_tpu_torch.parallel.mesh import Mesh
        from hands_tpu_torch.parallel.pipeline import pipeline_apply

        spec, dev = self.spec, torch.device(self.device)
        variant = spec.get("vit_variant", "h")
        images = int(spec.get("images", 4))
        gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        extra = {}
        if mode in ("tp_serve", "serve"):
            cfg = serving_config(spec["method"], "bfloat16", fused_block=True)
            model = fetch_model(cfg, dev, seed=self.cfg.seed,
                                vit_variant=variant)
            self.cut_depth(model, mode)
            if mode == "tp_serve":
                sharding.shard_vit_tp(model, self.model_axis())
            ds = SyntheticRecordDataset(cfg, "val", length=images * int(
                spec.get("requests", 3)))
            reqs = [[ds[i] for i in range(r, r + images)]
                    for r in range(0, len(ds), images)]
            keys = ("pred.mano.vertices.r", "pred.mano.vertices.l")

            def call(recs, i):
                out = serve(recs, cfg, model, dev)
                return {f"request{i}/{k}": out[k] for k in keys}

            return model, [lambda r=r, i=i: call(r, i)
                           for i, r in enumerate(reqs)], extra
        if mode in ("sp", "backbone"):
            if mode == "sp":
                self.model_axis()
                mesh = self._mesh
            else:
                mesh = Mesh.alone(("data", "model"), dev.type)
            bb = ViTBackbone(variant, device=dev, ring=mesh, ring_axis="model",
                             dtype=getattr(torch, spec.get("sp_dtype",
                                                           "bfloat16")))
            init_weights_(bb, gen)
            self.cut_depth(bb, mode)
            imgs = torch.randn((int(spec.get("sp_images", images)),)
                               + IMG_HW + (3,), generator=gen,
                               device=dev)
            if mode == "sp":
                shape = tuple(spec.get("attention", (2, 16, 2, 16)))
                q, k, v = (torch.randn(shape, generator=gen, device=dev)
                           for _ in range(3))
                ax = self.model_axis()
                with torch.inference_mode(), f32_exact():
                    ref = sequence.mha_reference(q, k, v)
                    sl = slice(ax.rank * shape[1] // ax.world,
                               (ax.rank + 1) * shape[1] // ax.world)
                    for fn in (sequence.sp_attention,
                               sequence.ring_attention):
                        got = fn(q[:, sl], k[:, sl], v[:, sl], ax)
                        extra[fn.__name__] = float(
                            (got - ref[:, sl]).abs().max())
            return bb, [lambda: {"features": bb(imgs)}], extra
        # "pp", "serial": the bf16 fused_block blocks
        bb = ViTBackbone(variant, dtype=torch.bfloat16, fused_block=True,
                         device=dev)
        init_weights_(bb, gen)
        self.cut_depth(bb, mode)
        n_tok = bb.grid_hw[0] * bb.grid_hw[1]
        xs = torch.randn((int(spec.get("microbatches", 4)),
                          int(spec.get("pp_crops", images)), n_tok,
                          bb.embed_dim), generator=gen, device=dev).to(
                              torch.bfloat16)

        def run(blocks, x):
            for b in blocks:
                x = b(x)
            return x

        blocks = list(bb.blocks)
        if mode == "serial":
            return bb, [lambda: {"out": torch.stack([run(blocks, x)
                                                     for x in xs])}], extra
        ax = self.model_axis()
        per = len(blocks) // ax.world
        mine = blocks[ax.rank * per:(ax.rank + 1) * per]
        bb.blocks = torch.nn.ModuleList(mine)  # this stage's blocks only
        return bb, [lambda: {"out": pipeline_apply(run, mine, xs, ax)}], extra

    def run_forward(self, mode: str):
        """A forward mode, or its one-process counterpart: a warm-up call,
        the held calls (their outputs kept), one more under the profiler."""
        from hands_tpu_torch.parallel import fsdp, sharding
        from hands_tpu_torch.utils.profiling import device_busy_ms

        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            module, calls, extra = self.forward_calls(mode)
            total = sum(p.numel() * p.element_size() * (
                1 if sharding.tp_shard_of(p) is None
                else sharding.tp_shard_of(p).tp.world)
                for p in module.parameters())
            calls[0]()  # warm-up
            _sync(self.device)
            outs, host_ms, launches = {}, 0.0, {}
            clock = CommClock() if mode in FORWARD else None
            first = launch_counts()
            try:
                for call in calls:
                    before = launch_counts()
                    if clock is not None:
                        clock.seconds = 0.0
                    t0 = time.perf_counter()
                    out = call()
                    _sync(self.device)
                    host_ms = 1e3 * (time.perf_counter() - t0)
                    launches = {k: v - before[k]
                                for k, v in launch_counts().items()
                                if v != before[k]}
                    outs.update({k: v.detach().to("cpu", copy=True)
                                 for k, v in out.items()})
            finally:
                if clock is not None:
                    clock.close()
            held = {k: v - first[k] for k, v in launch_counts().items()
                    if v != first[k]}
            device_ms = (device_busy_ms(calls[-1], warmup=False)[0]
                         if self.spec.get("profile", True) else None)
        summary = {
            "logs": [], "step_ms": host_ms, "device_ms": device_ms,
            "collective_ms": 0.0 if clock is None else 1e3 * clock.seconds,
            "held_gb": torch.cuda.memory_allocated() / 2 ** 30
            if cuda else None,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30
            if cuda else None,
            "launches": launches, "launches_held": held,
            "calls": len(calls),
            "shard_bytes": fsdp.shard_bytes(module), "total_bytes": total,
            **extra}
        keep = self.rank == 0 or mode in FORWARD.values()
        del module, calls
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return summary, {"outputs": outs if keep else {}, "buffers": {},
                         "logs": []}

    def run_f64(self, mode: str):
        """The first step's global loss and gradients in f64, the ranks of
        ``mode`` or one process (``reference``); nothing is updated."""
        from hands_tpu_torch.parallel import fsdp
        from hands_tpu_torch.train.state import global_norm
        from hands_tpu_torch.train.step import _logs, loss_and_grads
        from hands_tpu_torch.train.trainer import Trainer
        from hands_tpu_torch.utils import exact
        from hands_tpu_torch.utils.experiment import Experiment

        model = exact.f64_copy(self.model())
        dp = None
        if mode != "reference":
            cfg = self.cfg.replace(fsdp=mode == "fsdp", logger="none",
                                   mute=True)
            trainer = Trainer(cfg, model, Experiment(
                cfg, root=os.path.join(self.out_dir, "logs")))
            trainer.place_model()
            dp = trainer.dp
        batch = tuple(type(d)({k: (v.double() if torch.is_tensor(v)
                                   and v.is_floating_point() else v)
                               for k, v in d.items()})
                      for d in self.batches(sharded=dp is not None)[0])
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        gen = torch.Generator().manual_seed(self.cfg.seed)
        with exact.f64_route():
            total, loss_dict, grads = loss_and_grads(
                model, self.cfg, params, batch, gen, dp)
        logs = {k: float(v) for k, v in _logs(total, loss_dict, dp).items()}
        logs["grad_norm"] = float(global_norm(
            grads, [fsdp.is_sharded(p) for p in params], dp))
        keep = self.rank == 0 or mode == "reference"
        full = {n: fsdp.full(g, p) for n, g, p in zip(names, grads, params)}
        tensors = {"grads": {n: g.detach().to("cpu", copy=True)
                             for n, g in full.items()} if keep else {},
                   "params": {}, "mu": {}, "logs": [logs],
                   "buffers": {n: b.detach().to("cpu", copy=True)
                               for n, b in model.named_buffers()}}
        summary = {"logs": [logs], "step_ms": None, "device_ms": None,
                   "collective_ms": 0.0, "held_gb": None,
                   "peak_gb": None, "launches": {},
                   "shard_bytes": fsdp.shard_bytes(params),
                   "total_bytes": sum(p.numel() * p.element_size()
                                      for p in params)}
        return summary, tensors

    def compare(self, kept: dict) -> dict:
        """Rank 0's comparisons of the modes (see the module's text)."""
        out = {}
        for got, ref in FORWARD.items():
            if got in kept and ref in kept:
                out[f"{got}_vs_{ref}"] = _out_distance(
                    kept[got]["outputs"], kept[ref]["outputs"])
        kept = {m: t for m, t in kept.items()
                if m not in FORWARD and m not in FORWARD.values()}
        one = [m for m in ("reference", "split") if m in kept]
        pairs = [(m, r) for r in one for m in kept if m not in one]
        if "ddp" in kept and "fsdp" in kept:
            pairs.append(("fsdp", "ddp"))
        for got, ref in pairs:
            a, b = kept[got], kept[ref]
            c = out[f"{got}_vs_{ref}"] = {
                "loss_rel": [_rel(x["loss"], y["loss"])
                             for x, y in zip(a["logs"], b["logs"])],
                "grad_norm_rel": [_rel(x["grad_norm"], y["grad_norm"])
                                  for x, y in zip(a["logs"], b["logs"])],
                "grads": _worst(a["grads"], b["grads"]),
                "buffers": _worst(a["buffers"], b["buffers"])
                if a["buffers"] else None,
            }
            if (got, ref) == ("fsdp", "ddp"):  # the same steps on shards
                c["params"] = _worst(a["params"], b["params"])
                c["params_apart"] = _apart(a["params"], b["params"],
                                           0.5 * self.cfg.lr)
        return out


def _buffer_spread(buffers: Dict[str, torch.Tensor]) -> float:
    """The largest distance between any rank's running statistics and rank
    0's (an all-gather of every rank's buffers)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0.0
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, buffers)
    return max((float((b[n].double() - every[0][n].double()).abs().max())
                for b in every[1:] for n in b), default=0.0)


def run_rank(argv: List[str], spec: dict, out_dir: str) -> dict:
    from hands_tpu_torch.parallel.distributed import barrier

    rank = _Rank(argv, spec, out_dir)
    kept, summary = {}, {"rank": rank.rank, "world": rank.world,
                         "device": str(rank.device), "modes": {}}
    for mode in spec.get("modes", ["ddp"]):
        summary["modes"][mode], tensors = rank.run(mode)
        summary["modes"][mode]["bn_spread"] = _buffer_spread(
            tensors["buffers"])
        if rank.rank == 0:
            kept[mode] = tensors
    # the one-process runs last, so that the ranks' memory is theirs alone
    one = spec.get("reference") or []
    if rank.rank == 0:
        for mode in (["reference"] if one is True else one):
            summary["modes"][mode], kept[mode] = rank.run(mode)
        summary["compare"] = rank.compare(kept)
        if spec.get("save"):
            torch.save(kept, spec["save"])
    with open(os.path.join(out_dir, f"rank{rank.rank}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    barrier()
    return summary


def launch(spec_path: str, out_dir: str, ranks: int, extra: List[str],
           timeout_s: float, threads: int = 0) -> List[dict]:
    """Start ``ranks`` ranks of this module and read their summaries."""
    from hands_tpu_torch.parallel.launch import free_port, rank_env, run_ranks

    address = f"localhost:{free_port()}"
    cmds = [[sys.executable, "-m", "hands_tpu_torch.cli.parallel_check",
             "--spec", spec_path, "--out", out_dir,
             "--num_processes", str(ranks), "--process_id", str(r),
             "--coordinator_address", address] + list(extra)
            for r in range(ranks)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))  # where the package is importable
    run_ranks(cmds, timeout_s, env=rank_env(threads), cwd=root)
    out = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _pop(argv: List[str], flag: str, default: Optional[str] = None):
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None) -> int:
    import faulthandler

    faulthandler.enable()  # a rank that crashes says where
    argv = list(sys.argv[1:] if argv is None else argv)
    spec_path = _pop(argv, "--spec")
    out_dir = _pop(argv, "--out") or tempfile.mkdtemp()
    ranks = int(_pop(argv, "--ranks", "0"))
    timeout_s = float(_pop(argv, "--timeout", "900"))
    os.makedirs(out_dir, exist_ok=True)
    if ranks:
        for s in launch(spec_path, out_dir, ranks, argv, timeout_s):
            print(json.dumps(s))
        return 0
    with open(spec_path) as f:
        spec = json.load(f)
    run_rank(argv, spec, out_dir)
    return 0


if __name__ == "__main__":
    from hands_tpu_torch.parallel.distributed import shutdown

    code = main()
    shutdown()
    sys.exit(code)
