"""Port parity of the data-parallel pieces that run in one process
(``hands_tpu_torch.parallel``, the sharded loader) against the JAX package.

- The FSDP shard rule (``parallel/fsdp.py:fsdp_dim``) equals the JAX
  ``fsdp_spec`` on the shapes of tests/test_fsdp.py and at 2 ranks; on the
  tiny models' leaves the port's rule, read through each leaf's JAX layout
  (``jax_order``), picks the dimension that the JAX rule picks on the JAX
  leaf (carried across by ``utils/from_jax`` as a marker array), at the
  default floor and with every leaf large enough.
- ``host_shard_range`` and the mesh's ``-1`` equal the JAX ones; a mesh with
  an axis other than ``"data"`` raises, naming ROADMAP item 11; the backend
  rule (NCCL with a card per rank, else gloo).
- Each rank's loader (``DeviceDataLoader(shard=(r, 2))``, eval mode) against
  the JAX loader of the same shard on records, on the packed set and on a
  ``synthetic+synthetic`` mix, with and without ``drop_last``: images to
  2e-4 after normalisation (the crop-resampling divergence), everything else
  1e-5, ``num_valid`` and ``imgname`` equal; the two ranks' rows together
  are the one-process loader's rows; the divisibility guard raises in both.
- One process with no group: every data-parallel branch changes nothing
  (the bucketed all-reduce, the broadcast, the metric gather), and a rank
  other than 0 writes no log and no checkpoint.

The multi-process runs are tests/test_torch_multiprocess.py's.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from hands_tpu.config import default_config as jax_config
from hands_tpu.data import packed as jpk
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.datasets import fetch_dataset as jax_fetch_dataset
from hands_tpu.data.device_pipeline import DeviceDataLoader as JaxLoader
from hands_tpu.models.hamer_light import HamerLightModel as JaxHamer
from hands_tpu.models.hands_light import HandsLightModel as JaxHands
from hands_tpu.parallel import distributed as jdist
from hands_tpu.parallel.fsdp import fsdp_shardings, fsdp_spec
from hands_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data import packed as tpk
from hands_tpu_torch.data.datasets import SyntheticRecordDataset, fetch_dataset
from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
from hands_tpu_torch.models.hamer_light import HamerLightModel
from hands_tpu_torch.models.hands_light import HandsLightModel
from hands_tpu_torch.parallel import distributed as tdist
from hands_tpu_torch.parallel import fsdp, mesh
from hands_tpu_torch.train import checkpoint as ckpt_mod
from hands_tpu_torch.train.state import create_train_state
from hands_tpu_torch.utils import experiment as exp_mod
from hands_tpu_torch.utils.from_jax import state_dict_from_jax

KW = dict(backbone="resnet18", compute_dtype="float32", img_res=96,
          img_res_ds=64, use_render_seg_loss=False)
IMAGE_KEYS = ("img", "r_img", "l_img")
# tests/test_fsdp.py:test_fsdp_spec_rules, and more at 2 ranks
SHAPES = [(), (128,), (512, 2048), (4096, 1024), (513, 1023),
          (32, 640, 2560), (2048, 2048), (7, 7, 3, 64), (1, 192, 1280),
          (3, 4096), (2, 128, 384)]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- shard rule
def _spec_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "data"), None)


@pytest.mark.parametrize("n", [8, 2])
def test_shard_rule_is_the_jax_fsdp_spec(devices, n):
    jmesh = jax_make_mesh((n,), ("data",), devices=devices)
    for shape in SHAPES:
        for floor in (fsdp.MIN_SHARD_ELEMS, 1):
            want = _spec_dim(fsdp_spec(shape, jmesh, min_shard_elems=floor))
            assert fsdp.fsdp_dim(shape, n, floor) == want, (shape, floor)
    assert fsdp.fsdp_dim((4096, 1024), 1) is None  # one rank: whole


def _jax_variables(method):
    if method == "hamer_light":
        cfg = jax_config("hamer_light", compute_dtype="float32",
                         img_res=160, img_res_ds=160)
        model = JaxHamer(cfg, vit_variant="tiny")
        port = HamerLightModel(default_config(
            "hamer_light", compute_dtype="float32", img_res=160,
            img_res_ds=160), vit_variant="tiny")
    else:
        cfg = jax_config("hands_light", backbone="resnet18",
                         compute_dtype="float32", img_res=160,
                         img_res_ds=160)
        model = JaxHands(cfg)
        port = HandsLightModel(default_config(
            "hands_light", backbone="resnet18", compute_dtype="float32",
            img_res=160, img_res_ds=160))
    from hands_tpu.data.synthetic import make_batch

    inputs, _, meta = make_batch(cfg, 1, seed=0, np_arrays=True)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               inputs, meta))
    return shapes, port


@pytest.mark.parametrize("method", ["hamer_light", "hands_light"])
def test_shard_rule_on_the_tiny_models_leaves(devices, method):
    """Each JAX leaf becomes a marker (its index along the dimension the JAX
    rule shards, else zeros); ``state_dict_from_jax`` carries it into the
    port's layout, where it must vary along the port rule's dimension."""
    shapes, port = _jax_variables(method)
    jmesh = jax_make_mesh((2,), ("data",), devices=devices)
    names = dict(port.named_parameters())
    for floor in (fsdp.MIN_SHARD_ELEMS, 1):
        specs = fsdp_shardings(shapes["params"], jmesh, min_shard_elems=floor)

        def marker(leaf, sharding):
            d = _spec_dim(sharding.spec)
            out = np.zeros(leaf.shape, np.float32)
            if d is not None:
                idx = [None] * len(leaf.shape)
                idx[d] = slice(None)
                out = out + 1.0 + np.arange(leaf.shape[d],
                                            dtype=np.float32)[tuple(idx)]
            return out

        tree = {"params": jax.tree.map(marker, shapes["params"], specs)}
        if "batch_stats" in shapes:
            tree["batch_stats"] = jax.tree.map(
                lambda l: np.zeros(l.shape, np.float32),
                shapes["batch_stats"])
        carried = state_dict_from_jax(tree, port)
        checked = 0
        for name, p in names.items():
            m = carried[name].numpy()
            varies = [k for k in range(m.ndim) if m.shape[k] > 1
                      and np.ptp(m, axis=k).max() > 0]
            want = varies[0] if varies else None
            if varies == [] and m.max() > 0:  # a (1, ...) or stacked slice
                continue
            assert len(varies) <= 1, name
            got = fsdp.shard_dim(name, tuple(p.shape), 2, floor)
            assert got == want, (name, tuple(p.shape), floor, got, want)
            checked += 1
        assert checked > 0.9 * len(names), (checked, len(names))


def test_shard_units_are_blocks_and_stages():
    _, hamer = _jax_variables("hamer_light")
    units = fsdp.shard_units(hamer)
    assert len(units) == 2 and all(type(u).__name__ == "Block"
                                   for u in units)
    _, hands = _jax_variables("hands_light")
    units = fsdp.shard_units(hands)
    assert len(units) == 8  # 4 stages of each ResNet-18
    assert all(isinstance(u, list) and len(u) == 2 for u in units)
    assert fsdp.shard_bytes(hands) == sum(
        p.numel() * 4 for p in hands.parameters())


# ----------------------------------------------------------- mesh, ranks
def test_host_shard_range_and_mesh_shape_equal_jax():
    for pid in range(4):
        with mock.patch.object(jax, "process_index", lambda: pid), \
                mock.patch.object(jax, "process_count", lambda: 4), \
                mock.patch.object(tdist, "process_index", lambda: pid), \
                mock.patch.object(tdist, "process_count", lambda: 4):
            assert tdist.host_shard_range(64) == jdist.host_shard_range(64)
    assert tdist.host_shard_range(8) == (0, 8)  # one process
    for shape, world in (((-1,), 4), ((2, -1), 8), ((3,), 3)):
        assert mesh.resolve_shape(shape, world)[-1] == (
            world // (2 if len(shape) == 2 else 1)
            if -1 in shape else shape[-1])
    mesh.check_data_axes((-1,), ("data",))
    for shape, axes in (((1, 2), ("data", "model")), ((2,), ("model",))):
        with pytest.raises(NotImplementedError, match="item 11"):
            mesh.check_data_axes(shape, axes)


def test_backend_rule_and_addresses():
    assert tdist.backend_for("cpu", 2, 0) == "gloo"
    assert tdist.backend_for("cuda", 2, 1) == "gloo"  # two ranks, one card
    assert tdist.backend_for("cuda", 2, 2) == "nccl"
    assert tdist.backend_for("cuda", 8, 4) == "gloo"
    assert tdist.init_method("host:1234") == "tcp://host:1234"
    assert tdist.init_method("file:///tmp/x") == "file:///tmp/x"
    assert tdist.init_method("") == "env://"
    assert tdist.device_for(3, "cpu") == torch.device("cpu")
    cfg = default_config("hands_light")
    assert tdist.initialize_from_config(cfg, "cpu") == (cfg, "cpu")
    assert tdist.data_group() is None and not tdist.is_multiprocess()


def test_shard_batch_takes_each_ranks_rows():
    batch = ({"img": np.arange(8).reshape(4, 2)},
             {"v": torch.arange(4.0)},
             {"imgname": ["a", "b", "c", "d"], "n": 4,
              "s": torch.tensor(2.0)})
    rows = [mesh.shard_batch(batch, r, 2) for r in range(2)]
    assert rows[1][0]["img"].tolist() == [[4, 5], [6, 7]]
    assert rows[0][1]["v"].tolist() == [0.0, 1.0]
    assert rows[1][2]["imgname"] == ["c", "d"] and rows[1][2]["n"] == 4
    assert float(rows[0][2]["s"]) == 2.0
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(batch, 0, 3)


def test_one_process_branches_change_nothing(tmp_path):
    ts = [torch.arange(5.0), torch.ones(3, 2), torch.zeros(2, dtype=torch.int64)]
    before = [t.clone() for t in ts]
    mesh.reduce_mean_(ts, None)
    mesh.broadcast_(ts, None)
    assert all(torch.equal(a, b) for a, b in zip(ts, before))
    buckets = mesh._buckets(ts, bucket_bytes=24)
    assert [len(b) for b in buckets] == [1, 1, 1]  # size, then dtype
    assert [len(b) for b in mesh._buckets(ts[:2], 1 << 20)] == [2]
    metrics = {"pix_err": torch.arange(3.0), "n": 3}
    assert tdist.gather_to_host(metrics) is metrics
    assert mesh.active() is None
    with mesh.data_parallel(mesh.DataGroup(None, 0, 1)):
        assert mesh.active() is None  # a group of one is one process


def test_a_rank_other_than_0_writes_no_log_and_no_checkpoint(tmp_path):
    cfg = default_config("hands_light", backbone="resnet18", exp_key="r1",
                         logger="none")
    with mock.patch.object(exp_mod, "process_index", lambda: 1):
        exp = exp_mod.Experiment(cfg, root=str(tmp_path))
        exp.log_dict({"loss": 1.0}, 1)
        exp.close()
    assert sorted(os.listdir(tmp_path / "r1")) == ["checkpoints"]
    model = torch.nn.Linear(2, 2)
    state = create_train_state(cfg, model)
    manager = ckpt_mod.CheckpointManager(str(tmp_path / "c"))
    with mock.patch.object(ckpt_mod, "process_index", lambda: 1):
        manager.save_last(state, 1)
        manager.save_top_k(state, 0, 1.0)
    assert os.listdir(tmp_path / "c") == []
    manager.save_last(state, 1)  # rank 0 (one process) writes
    assert os.listdir(tmp_path / "c") == ["last"]


# ---------------------------------------------------------------- loader
def _jax_and_port(kind, tmp_path):
    cfg_j, cfg_t = jax_config("hands_light", **KW), default_config(
        "hands_light", **KW)
    if kind == "records":
        return (cfg_j, JaxSynthetic(cfg_j, "train", length=7),
                cfg_t, SyntheticRecordDataset(cfg_t, "train", length=7))
    if kind == "mix":
        return (cfg_j, jax_fetch_dataset(cfg_j, "synthetic+synthetic",
                                         "tinyval"),
                cfg_t, fetch_dataset(cfg_t, "synthetic+synthetic", "tinyval"))
    jpk.pack_dataset(JaxSynthetic(cfg_j, "train", length=7),
                     str(tmp_path / "jax"), chunk=4)
    tpk.pack_dataset(SyntheticRecordDataset(cfg_t, "train", length=7),
                     str(tmp_path / "port"), chunk=4)
    return (cfg_j, jpk.PackedRecordDataset(str(tmp_path / "jax")),
            cfg_t, tpk.PackedRecordDataset(str(tmp_path / "port")))


@pytest.mark.parametrize("kind", ["records", "packed", "mix"])
def test_each_ranks_loader_rows_match_jax(kind, tmp_path):
    cfg_j, ds_j, cfg_t, ds_t = _jax_and_port(kind, tmp_path)
    B = 4
    for drop_last in (False, True):
        whole = list(DeviceDataLoader(ds_t, cfg_t, B, is_train=False,
                                      drop_last=drop_last, num_workers=0,
                                      device="cpu"))
        ranks = []
        for r in range(2):
            jl = JaxLoader(ds_j, cfg_j, B, is_train=False, seed=0,
                           drop_last=drop_last, num_workers=0, shard=(r, 2))
            tl = DeviceDataLoader(ds_t, cfg_t, B, is_train=False,
                                  drop_last=drop_last, num_workers=0,
                                  shard=(r, 2), device="cpu")
            assert len(jl) == len(tl) == len(whole)
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == len(whole)
            for (ji, jt, jm), (ti, tt, tm) in zip(jb, tb):
                assert list(jm["imgname"]) == list(tm["imgname"])
                assert jm["num_valid"] == tm["num_valid"]
                for ref, got in ((ji, ti), (jt, tt), (jm, tm)):
                    assert set(ref) == set(got)
                    for k in ref:
                        if k in ("imgname", "num_valid"):
                            continue
                        a, b = np.asarray(ref[k]), np.asarray(got[k])
                        atol = 2e-4 if k in IMAGE_KEYS else 1e-5
                        np.testing.assert_allclose(
                            b, a, rtol=1e-6, atol=atol, equal_nan=True,
                            err_msg=f"{kind} rank {r} {k}")
            ranks.append(tb)
        for w, r0, r1 in zip(whole, *ranks):  # the ranks' rows together
            assert r0[2]["num_valid"] + r1[2]["num_valid"] == \
                w[2]["num_valid"]
            assert r0[2]["imgname"] + r1[2]["imgname"] == w[2]["imgname"]
            for k in ("img", "r_img"):
                torch.testing.assert_close(
                    torch.cat([r0[0][k], r1[0][k]]), w[0][k], rtol=0,
                    atol=0)
            torch.testing.assert_close(
                torch.cat([r0[1]["is_valid"], r1[1]["is_valid"]]),
                w[1]["is_valid"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        JaxLoader(ds_j, cfg_j, 3, is_train=False, shard=(0, 2))
    with pytest.raises(ValueError, match="not divisible"):
        DeviceDataLoader(ds_t, cfg_t, 3, is_train=False, shard=(0, 2),
                         device="cpu")


def test_ranks_draw_their_own_augmentations():
    """The divergence beside the epoch generator's: in train mode each
    rank's generator is seeded with its rank too (the JAX loader folds the
    shard into its key), so the ranks' draws differ; the order of records is
    the one global order."""
    cfg = default_config("hands_light", **KW)
    ds = SyntheticRecordDataset(cfg, "train", length=8)
    gens = [DeviceDataLoader(ds, cfg, 4, is_train=True, num_workers=0,
                             shard=(r, 2), device="cpu").begin_epoch()
            for r in range(2)]
    one = DeviceDataLoader(ds, cfg, 4, is_train=True, num_workers=0,
                           device="cpu").begin_epoch()
    assert all(np.array_equal(o, one[0]) for o, _ in gens)
    draws = [torch.rand(4, generator=g) for _, g in gens + [one]]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
