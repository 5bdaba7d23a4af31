"""Port parity of the loaders: ``hands_tpu_torch.data.device_pipeline``
(``DeviceDataLoader``, ``PrefetchLoader``) and ``data.factory`` against the
JAX package's, on the same synthetic dataset.

Eval mode draws nothing, so batch contents are compared key by key (geometry
1e-5, images 2e-4 after normalisation, as tests/test_torch_preprocess.py).
Train mode draws from different generators; what must agree is what comes
from numpy: the shuffled order of every epoch.
"""

import os

import numpy as np
import pytest
import torch

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.device_pipeline import DeviceDataLoader as JaxLoader
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.datasets import (ConcatDataset, DataNotFoundError,
                                           SyntheticRecordDataset,
                                           fetch_dataset)
from hands_tpu_torch.data.device_pipeline import (DeviceDataLoader,
                                                  PrefetchLoader,
                                                  stack_records)
from hands_tpu_torch.data.factory import collate_windowed, fetch_dataloader

KW = dict(backbone="resnet18", compute_dtype="float32", img_res=96,
          img_res_ds=64, use_render_seg_loss=False)
IMAGE_KEYS = ("img", "r_img", "l_img")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side, and
    eight threads each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(n, batch, is_train, **kw):
    cfg_j, cfg_t = jax_config("hands_light", **KW), default_config(
        "hands_light", **KW)
    jl = JaxLoader(JaxSynthetic(cfg_j, "train", length=n), cfg_j, batch,
                   is_train=is_train, seed=3, **kw)
    tl = DeviceDataLoader(SyntheticRecordDataset(cfg_t, "train", length=n),
                          cfg_t, batch, is_train=is_train, seed=3,
                          device="cpu", **kw)
    return jl, tl


@pytest.mark.parametrize("drop_last,workers", [(False, 0), (True, 2)])
def test_eval_loader_matches_jax(drop_last, workers):
    jl, tl = _pair(7, 3, False, drop_last=drop_last, num_workers=workers)
    assert len(jl) == len(tl) == (2 if drop_last else 3)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl)
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
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=atol,
                                           equal_nan=True, err_msg=k)
    if not drop_last:  # the tail: 1 real row, 2 padded and invalidated
        _, tt, tm = tb[-1]
        assert tm["num_valid"] == 1 and len(tm["imgname"]) == 1
        assert tt["is_valid"].tolist() == [1.0, 0.0, 0.0]
        assert tt["right_valid"].tolist() == [1.0, 0.0, 0.0]
        assert tb[-1][0]["img"].shape[0] == 3


def test_train_loader_shuffles_as_jax_and_peek_keeps_the_epoch():
    jl, tl = _pair(6, 2, True, num_workers=0)
    # only the JAX loader's order is read: spare its preprocessing's compile
    jl.pre = lambda stacked, key: ({}, {}, {})
    first = tl.peek()
    assert tl._epoch == 0
    epochs = []
    for epoch in range(2):
        names_j = [n for _, _, m in jl for n in m["imgname"]]
        batches = list(tl)
        epochs.append(batches)
        names_t = [n for _, _, m in batches for n in m["imgname"]]
        assert names_j == names_t and len(set(names_t)) == 6
        if epoch == 0:  # peek gave the epoch's first batch, draws included
            torch.testing.assert_close(batches[0][0]["img"], first[0]["img"],
                                       rtol=0, atol=0)
            order0 = names_t
    assert names_t != order0  # every epoch reshuffles
    assert tl._epoch == 2
    tl.set_epoch(0)
    again = [n for _, _, m in tl for n in m["imgname"]]
    assert again == order0
    # train mode augments, and every epoch draws anew
    scales = [torch.cat([i["r_bbox"] for i, _, _ in b]) for b in epochs]
    assert not torch.equal(scales[0], scales[1])


@pytest.mark.parametrize("is_train", [False, True])
def test_prefetch_loader_yields_the_sequential_batches(is_train):
    """The port's version of tests/test_trainer.py's
    ``test_prefetch_loader_delegates_trainer_interface``."""
    cfg = default_config("hands_light", dataset="synthetic",
                         trainsplit="tinytrain", batch_size=2, num_workers=2,
                         seed=1, **KW)
    if is_train:
        loader = fetch_dataloader(cfg, "train", device="cpu")
        plain = DeviceDataLoader(loader.dataset, cfg, 2, is_train=True,
                                 seed=1, device="cpu")
    else:
        plain = DeviceDataLoader(fetch_dataset(cfg, "synthetic", "tinytrain"),
                                 cfg, 2, is_train=False, device="cpu")
        loader = PrefetchLoader(plain)
        plain = DeviceDataLoader(plain.dataset, cfg, 2, is_train=False,
                                 device="cpu")
    assert isinstance(loader, PrefetchLoader)
    assert len(loader) == len(plain) == 2
    first = loader.peek()  # must not consume the first epoch's batch
    loader.set_epoch(0)
    got, want = list(loader), list(plain)
    assert len(got) == len(loader)
    torch.testing.assert_close(got[0][0]["img"], first[0]["img"],
                               rtol=0, atol=0)
    for (gi, gt, gm), (wi, wt, wm) in zip(got, want):
        assert gm["imgname"] == wm["imgname"]
        for g, w in ((gi, wi), (gt, wt)):
            for k in w:
                torch.testing.assert_close(g[k], w[k], rtol=0, atol=0,
                                           equal_nan=True)
    assert loader.wait_seconds >= 0.0 and loader.batch_size == 2
    # an abandoned iteration stops its thread; an error in the host half
    # reaches the consumer
    it = iter(loader)
    next(it)
    it.close()

    class Broken(SyntheticRecordDataset):
        def __getitem__(self, idx):
            raise OSError("unreadable record")

    bad = PrefetchLoader(DeviceDataLoader(
        Broken(cfg, "tinytrain"), cfg, 2, is_train=False, device="cpu"))
    with pytest.raises(OSError, match="unreadable"):
        list(bad)


def test_factory_and_what_is_left_out():
    cfg = default_config("hands_light", dataset="synthetic",
                         val_dataset="synthetic", batch_size=2,
                         test_batch_size=4, num_workers=0, **KW)
    train = fetch_dataloader(cfg, "train", device="cpu")
    val = fetch_dataloader(cfg, "val", device="cpu")
    assert isinstance(train, DeviceDataLoader) and train.is_train
    assert not val.is_train and not val.drop_last and val.batch_size == 4
    assert len(val) == 2  # minival: 6 records
    with pytest.raises(ValueError):
        fetch_dataloader(cfg, "holdout", device="cpu")
    with pytest.MonkeyPatch.context() as mp:  # an empty $DATA_DIR
        mp.setenv("DATA_DIR", os.path.join(os.sep, "no_such_data_dir"))
        with pytest.raises(DataNotFoundError, match="no_such_data_dir"):
            fetch_dataset(cfg, "epic", "train")
    mix = fetch_dataset(cfg, "synthetic+synthetic", "minitrain")
    assert isinstance(mix, ConcatDataset) and len(mix) == 2 * 12
    assert mix[12].imgname == mix[0].imgname
    with pytest.raises(KeyError):
        fetch_dataset(cfg, "no_such_set", "train")
    ds = fetch_dataset(cfg, "synthetic", "minitrain")
    # the sharded loader: each rank's rows (tests/test_torch_parallel.py),
    # a global batch the ranks divide
    assert len(DeviceDataLoader(ds, cfg, 2, False, shard=(1, 2),
                                device="cpu")) == len(ds) // 2
    with pytest.raises(ValueError, match="not divisible"):
        DeviceDataLoader(ds, cfg, 3, False, shard=(0, 2), device="cpu")
    # a dataset that stacks its own batches takes the stacked path
    asked = []

    def stacked_batch(idxs):
        asked.append(list(idxs))
        return stack_records([ds[int(i)] for i in idxs])

    ds.stacked_batch = stacked_batch
    loader = DeviceDataLoader(ds, cfg, 5, False, drop_last=False,
                              device="cpu")
    out = list(loader.host_batches(np.arange(len(ds))))
    assert asked == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]
    assert [n for _, n in out] == [5, 5, 2]
    assert out[-1][0]["is_valid"].tolist() == [1, 1, 0, 0, 0]


def test_collate_windowed_concatenates_windows():
    def sample(i):
        return ({"img": np.full((2, 3), i, np.float32)},
                {"is_valid": np.ones(2, np.float32)},
                {"imgname": [f"a{i}", f"b{i}"],
                 "intrinsics": np.zeros((2, 3, 3), np.float32)})

    inputs, targets, meta = collate_windowed([sample(0), sample(1)])
    assert inputs["img"].shape == (4, 3) and inputs["img"][2, 0] == 1.0
    assert targets["is_valid"].shape == (4,)
    assert meta["imgname"] == ["a0", "b0", "a1", "b1"]
    assert meta["intrinsics"].shape == (4, 3, 3)
