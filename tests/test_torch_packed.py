"""Port parity of the packed-record path: ``hands_tpu_torch.data.packed``
(``pack_dataset``, ``PackedRecordDataset``, ``downscale_record``), the
loader's stacked path and ``cli.pack_records``, against the JAX package.

- The format: the port packs the same records into the same files as the
  JAX package, byte for byte, ``meta.json`` equal; each package reads the
  other's directory. The two packages' synthetic sets are not the same
  records: their MANO forwards round the labels differently, so j2d moves
  by up to 1.3e-4 px and j3d by 6e-8 m; their packs are equal byte for byte
  in every other file.
- Within the port, bit for bit: ``stacked_batch`` and the Record view
  against ``stack_records``, and the loader over the packed set against the
  loader over the records (eval, and train with one generator; the tail
  padded).
- Against the JAX loader over the JAX pack: eval batches within
  tests/test_torch_loader.py's tolerances (images 2e-4 after normalisation,
  the crop-resampling divergence; the rest 1e-5).
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.device_pipeline import DeviceDataLoader as JaxLoader
from hands_tpu.data import packed as jpk
from hands_tpu_torch.cli import pack_records
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data import packed as tpk
from hands_tpu_torch.data.datasets import (DataNotFoundError,
                                           SyntheticRecordDataset)
from hands_tpu_torch.data.device_pipeline import (DeviceDataLoader,
                                                  PrefetchLoader,
                                                  stack_records)

KW = dict(backbone="resnet18", compute_dtype="float32", img_res=96,
          img_res_ds=64, use_render_seg_loss=True)
N = 10
LABEL_FILES = {"j2d_r.npy": 2e-4, "j2d_l.npy": 2e-4, "j3d_r.npy": 1e-7,
               "j3d_l.npy": 1e-7}
IMAGE_KEYS = ("img", "r_img", "l_img")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Each package's synthetic set and its pack (chunk 4 < N: several
    chunks), and the JAX records packed by the port."""
    tmp = tmp_path_factory.mktemp("packed")
    jds = JaxSynthetic(jax_config("hands_light", **KW), "train", length=N)
    tds = SyntheticRecordDataset(default_config("hands_light", **KW), "train",
                                 length=N)
    dirs = {k: str(tmp / k) for k in ("jax", "port", "port_of_jax")}
    jpk.pack_dataset(jds, dirs["jax"], chunk=4)
    tpk.pack_dataset(tds, dirs["port"], chunk=4)
    tpk.pack_dataset(jds, dirs["port_of_jax"], chunk=4)
    return jds, tds, dirs


def _files(d):
    return sorted(os.listdir(d))


def _assert_stacked_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k], k
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def test_the_port_packs_the_jax_format_byte_for_byte(packs):
    _, _, dirs = packs
    names = _files(dirs["jax"])
    assert names == _files(dirs["port_of_jax"])
    assert "meta.json" in names and "image.npy" in names
    _, mismatch, errors = filecmp.cmpfiles(dirs["jax"], dirs["port_of_jax"],
                                           names, shallow=False)
    assert mismatch == errors == []
    meta = json.load(open(os.path.join(dirs["port_of_jax"], "meta.json")))
    assert meta["version"] == 1 and meta["n"] == N and meta["downscale"] == 1


def test_the_two_synthetic_packs_agree(packs):
    """Every file byte for byte but the four label files, which carry the
    two MANO forwards' rounding."""
    _, _, dirs = packs
    names = _files(dirs["jax"])
    assert names == _files(dirs["port"])
    same = [n for n in names if n not in LABEL_FILES]
    _, mismatch, errors = filecmp.cmpfiles(dirs["jax"], dirs["port"], same,
                                           shallow=False)
    assert mismatch == errors == []
    for name, atol in LABEL_FILES.items():
        a, b = (np.load(os.path.join(dirs[k], name)) for k in ("jax", "port"))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_directory(packs, reader, writer):
    _, _, dirs = packs
    cls = {"port": tpk.PackedRecordDataset, "jax": jpk.PackedRecordDataset}
    got = cls[reader](dirs[writer])
    ref = cls[writer](dirs[writer])
    assert len(got) == len(ref) == N
    idxs = [7, 0, 3, 9]
    _assert_stacked_equal(ref.stacked_batch(idxs), got.stacked_batch(idxs))
    a, b = ref[5], got[5]
    assert a.imgname == b.imgname and a.loss_flags == b.loss_flags
    assert a.image.tobytes() == b.image.tobytes()


@pytest.mark.parametrize("ram_bytes", [1 << 20, tpk._RAM_FIELD_BYTES])
def test_stacked_batch_and_record_view_equal_stack_records(
        packs, monkeypatch, ram_bytes):
    """With the pixel field memory-mapped (row copies) and read into RAM."""
    _, tds, dirs = packs
    monkeypatch.setattr(tpk, "_RAM_FIELD_BYTES", ram_bytes)
    pds = tpk.PackedRecordDataset(dirs["port"])
    assert isinstance(pds.fields["image"], np.memmap) == (ram_bytes < 1 << 22)
    assert not isinstance(pds.fields["K"], np.memmap)
    idxs = [3, 0, 7, 9, 3]
    direct = stack_records([tds[i] for i in idxs])
    _assert_stacked_equal(direct, pds.stacked_batch(idxs))
    _assert_stacked_equal(direct, stack_records([pds[i] for i in idxs]))
    rec, back = tds[2], pds[2]
    assert back.image.dtype == np.uint8
    assert type(back.use_gt_k) is type(rec.use_gt_k)
    assert (back.r_bbox is None) == (rec.r_bbox is None)


def _batches(loader):
    return [(dict(i), dict(t), dict(m)) for i, t, m in loader]


@pytest.mark.parametrize("is_train", [False, True])
def test_loader_over_the_pack_equals_it_over_the_records(packs, is_train):
    """Same order, same augmentation draws, the tail padded by repeating its
    last row (10 records -> 4 + 4 + 2 real rows): bit for bit."""
    _, tds, dirs = packs
    cfg = default_config("hands_light", **KW, flip_prob=0.5)
    kw = dict(cfg=cfg, batch_size=4, is_train=is_train, seed=3,
              num_workers=0, drop_last=False, device="cpu")
    live = DeviceDataLoader(tds, **kw)
    fast = DeviceDataLoader(tpk.PackedRecordDataset(dirs["port"]), **kw)
    got = _batches(fast)
    loaders = [live] + ([PrefetchLoader(DeviceDataLoader(
        tpk.PackedRecordDataset(dirs["port"]), **kw))] if is_train else [])
    for ref_loader in loaders:
        ref = _batches(ref_loader)
        assert len(ref) == len(got) == 3
        for (i1, t1, m1), (i2, t2, m2) in zip(ref, got):
            assert m1["imgname"] == m2["imgname"]
            assert m1["num_valid"] == m2["num_valid"]
            for d1, d2 in ((i1, i2), (t1, t2), (m1, m2)):
                assert set(d1) == set(d2)
                for k, v in d1.items():
                    if isinstance(v, torch.Tensor):
                        assert torch.equal(v, d2[k]), k
    _, tail_t, tail_m = got[-1]
    assert tail_m["num_valid"] == 2 and len(tail_m["imgname"]) == 2
    for k in ("is_valid", "right_valid", "left_valid"):
        assert tail_t[k].tolist() == [1.0, 1.0, 0.0, 0.0], k
    if is_train:
        assert float(got[0][2]["is_flipped"].sum()) > 0


def test_loader_over_the_pack_matches_the_jax_loader(packs):
    _, _, dirs = packs
    kw = dict(batch_size=4, is_train=False, seed=3, num_workers=0,
              drop_last=False)
    jl = JaxLoader(jpk.PackedRecordDataset(dirs["jax"]),
                   jax_config("hands_light", **KW), **kw)
    tl = DeviceDataLoader(tpk.PackedRecordDataset(dirs["port"]),
                          default_config("hands_light", **KW), device="cpu",
                          **kw)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 3
    for (ji, jt, jm), (ti, tt, tm) in zip(jb, tb):
        assert list(jm["imgname"]) == list(tm["imgname"])
        assert jm["num_valid"] == tm["num_valid"]
        for ref, got in ((ji, ti), (jt, tt), (jm, tm)):
            assert set(ref) == set(got)
            for k in ref:
                if k in ("imgname", "num_valid"):
                    continue
                atol = 2e-4 if k in IMAGE_KEYS else 1e-5
                np.testing.assert_allclose(
                    np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-6,
                    atol=atol, equal_nan=True, err_msg=k)


def test_downscale_round_trip(packs, tmp_path):
    """``downscale_record`` as the JAX one, and ``pack_dataset(downscale=2)``
    as the stack of downscaled records, ``meta.json`` recording the factor;
    k = 1 is the identity."""
    jds, _, _ = packs
    for i in (0, 1):
        rec = jds[i]
        rec.mask = np.where(rec.image[..., 0] > 30, 255, 127).astype(np.uint8)
        rec.depth = rec.image[..., 1].astype(np.float32) / 60.0
        rec.r_bbox = np.asarray([10.0, 20.0, 90.0, 120.0], np.float32)
        a = jpk.downscale_record(rec, 3)
        rec = jds[i]
        rec.mask = np.where(rec.image[..., 0] > 30, 255, 127).astype(np.uint8)
        rec.depth = rec.image[..., 1].astype(np.float32) / 60.0
        rec.r_bbox = np.asarray([10.0, 20.0, 90.0, 120.0], np.float32)
        b = tpk.downscale_record(rec, 3)
        _assert_stacked_equal(stack_records([a]), stack_records([b]))
    assert tpk.downscale_record(jds[1], 1).image.tobytes() == \
        jds[1].image.tobytes()
    out = str(tmp_path / "ds2")
    tpk.pack_dataset(jds, out, chunk=4, downscale=2)
    assert json.load(open(os.path.join(out, "meta.json")))["downscale"] == 2
    direct = stack_records([tpk.downscale_record(jds[i], 2) for i in range(N)])
    _assert_stacked_equal(direct,
                          tpk.PackedRecordDataset(out).stacked_batch(range(N)))
    jout = str(tmp_path / "jds2")
    jpk.pack_dataset(jds, jout, chunk=4, downscale=2)
    _, mismatch, errors = filecmp.cmpfiles(out, jout, _files(jout),
                                           shallow=False)
    assert mismatch == errors == []


def test_pack_records_cli(tmp_path, capsys):
    out = str(tmp_path / "p")
    assert pack_records.main(["--synthetic", "6", "--out", out,
                              "--chunk", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"packed", "n", "seconds", "bytes",
                         "records_per_sec"}
    assert line["n"] == 6 and line["packed"] == out and line["bytes"] > 0
    pds = tpk.PackedRecordDataset(out)
    ds = SyntheticRecordDataset(default_config("hands_light"), "train",
                                length=6)
    _assert_stacked_equal(stack_records([ds[i] for i in range(6)]),
                          pds.stacked_batch(range(6)))
    with pytest.MonkeyPatch.context() as mp:  # an empty $DATA_DIR
        mp.setenv("DATA_DIR", str(tmp_path / "no_data"))
        with pytest.raises(DataNotFoundError, match="no_data"):
            pack_records.main(["--dataset", "epic", "--out",
                               str(tmp_path / "e")])
