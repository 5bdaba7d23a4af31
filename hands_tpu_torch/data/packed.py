"""Packed record shards: the decode-free input format (the port's own copy of
``hands_tpu/data/packed.py``; the on-disk format is that module's, so a
directory packed by either package reads back identically in the other).

A dataset is packed once into one memory-mapped ``.npy`` file a field (uint8
images, float labels, one row a record), in the encodings of
``stack_records``. Loading is then a row copy out of the page cache a field:
no image decode and no per-record Python.

Layout of a packed directory:
  meta.json             {"version": 1, "n": N, "fields": [...], "lists": {...},
                         "downscale": k}
  <field>.npy           (N, *shape) arrays, np.load(mmap_mode="r")-able

:func:`pack_dataset` writes it from any Record dataset;
:class:`PackedRecordDataset` reads it back as Records or as whole stacked
batches (``stacked_batch``), which ``DeviceDataLoader`` takes instead of
the per-record path whenever a dataset has it.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from hands_tpu_torch.data.records import LOSS_FLAGS, Record

_VERSION = 1

# fields at or under this size are read fully into RAM at open time
_RAM_FIELD_BYTES = 1 << 26


def downscale_record(rec: Record, k: int) -> Record:
    """Scale a record's image (area average) and every image-pixel-space field
    by an integer factor ``k`` (the pack-time resolution knob), in place.

    The pixel-space fields (K, j2d xy, bbox, detected boxes, mask and depth
    resolution) scale together, so the crop geometry and the crop-adjusted
    intrinsics are invariant; ``wp_focal`` (already at ``img_res``) and
    ``dist`` (normalised coordinates) are untouched.
    """
    if k <= 1:
        return rec
    img = np.asarray(rec.image)
    H, W = img.shape[:2]
    H2, W2 = H // k, W // k
    crop = img[: H2 * k, : W2 * k]
    if crop.dtype != np.uint8:
        crop = np.clip(crop, 0, 255).astype(np.uint8)
    acc = crop.reshape(H2, k, W2, k, -1).astype(np.uint32).sum(axis=(1, 3))
    rec.image = ((acc + k * k // 2) // (k * k)).astype(np.uint8)
    s = np.float32(1.0 / k)
    K = np.array(rec.K, np.float32)
    K[:2] *= s
    rec.K = K
    for name in ("j2d_r", "j2d_l"):
        j = np.array(getattr(rec, name), np.float32)
        j[:, :2] *= s
        setattr(rec, name, j)
    rec.bbox = np.asarray(rec.bbox, np.float32) * s
    if rec.r_bbox is not None:
        rec.r_bbox = np.asarray(rec.r_bbox, np.float32) * s
    if rec.l_bbox is not None:
        rec.l_bbox = np.asarray(rec.l_bbox, np.float32) * s
    # nearest (cell-centre) subsample: keeps the R=255 / L=127 mask coding
    # and mixes no depth across object edges
    o = k // 2
    if rec.mask is not None:
        rec.mask = np.ascontiguousarray(
            np.asarray(rec.mask)[o:H2 * k:k, o:W2 * k:k])
    if rec.depth is not None:
        rec.depth = np.ascontiguousarray(
            np.asarray(rec.depth)[o:H2 * k:k, o:W2 * k:k])
    return rec


def pack_dataset(dataset, out_dir: str, chunk: int = 64,
                 downscale: int = 1) -> str:
    """Pack any Record dataset into memory-mapped shards, in dataset order,
    ``chunk`` records a ``stack_records`` call. ``downscale`` > 1 packs at
    reduced resolution (:func:`downscale_record`)."""
    from hands_tpu_torch.data.device_pipeline import stack_records

    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    if n == 0:
        raise ValueError("cannot pack an empty dataset")

    mmaps = {}
    lists = {}
    for start in range(0, n, chunk):
        idxs = range(start, min(start + chunk, n))
        stacked = stack_records(
            [downscale_record(dataset[i], downscale) for i in idxs])
        for key, val in stacked.items():
            if isinstance(val, list):
                lists.setdefault(key, []).extend(val)
                continue
            val = np.asarray(val)
            if key not in mmaps:
                mmaps[key] = np.lib.format.open_memmap(
                    os.path.join(out_dir, f"{key}.npy"), mode="w+",
                    dtype=val.dtype, shape=(n,) + val.shape[1:])
            mmaps[key][start:start + val.shape[0]] = val
    for m in mmaps.values():
        m.flush()
    meta = {
        "version": _VERSION,
        "n": n,
        "fields": sorted(mmaps),
        "lists": lists,
        "downscale": downscale,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


class PackedRecordDataset:
    """Reads a packed directory.

    - ``__getitem__`` -> Record (the inverse of ``stack_records``'
      encodings), so any consumer of Records takes it unchanged;
    - ``stacked_batch(indices)`` -> the stacked dict itself, one row copy a
      field and record out of the memory map; ``DeviceDataLoader`` sees the
      method and skips the per-record path.
    """

    name = "packed"

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _VERSION:
            raise ValueError(f"unknown packed version {self.meta}")
        self.n = self.meta["n"]
        # small label fields are read into RAM outright (numpy's fancy index
        # on a memmap is a slow generic gather); only the large pixel fields
        # stay memory-mapped
        self.fields = {}
        for key in self.meta["fields"]:
            arr = np.load(os.path.join(path, f"{key}.npy"), mmap_mode="r")
            if arr.nbytes <= _RAM_FIELD_BYTES:
                arr = np.array(arr)
            self.fields[key] = arr
        self.lists = self.meta["lists"]

    def __len__(self):
        return self.n

    def stacked_batch(self, indices: Sequence[int]) -> dict:
        idx = np.asarray(indices, np.int64)
        out = {}
        for key, arr in self.fields.items():
            if isinstance(arr, np.memmap):
                # one contiguous copy a row out of the page cache
                batch = np.empty((len(idx),) + arr.shape[1:], arr.dtype)
                for j, i in enumerate(idx):
                    batch[j] = arr[i]
                out[key] = batch
            else:
                out[key] = arr[idx]
        for key, val in self.lists.items():
            out[key] = [val[i] for i in idx]
        return out

    def __getitem__(self, i: int) -> Record:
        f = self.fields

        def opt(key):
            return f[key][i] if key in f else None

        use_gt_k = float(f["use_gt_k"][i])
        wp_focal = float(f["wp_focal"][i])
        return Record(
            imgname=self.lists["_imgnames"][i],
            dataset=self.lists["_dataset"][i],
            image=f["image"][i],
            K=f["K"][i],
            j2d_r=f["j2d_r"][i], j2d_l=f["j2d_l"][i],
            j3d_r=f["j3d_r"][i], j3d_l=f["j3d_l"][i],
            pose_r=f["pose_r"][i], pose_l=f["pose_l"][i],
            beta_r=f["beta_r"][i], beta_l=f["beta_l"][i],
            bbox=f["bbox"][i],
            r_bbox=f["r_bbox_det"][i] if f["r_bbox_ok"][i] > 0 else None,
            l_bbox=f["l_bbox_det"][i] if f["l_bbox_ok"][i] > 0 else None,
            bbox_mode=float(f["bbox_mode"][i]),
            is_egocam=float(f["is_egocam"][i]),
            use_gt_k=None if use_gt_k < 0 else use_gt_k,
            wp_focal=None if wp_focal < 0 else wp_focal,
            dist=f["_dist"][i],
            grasp_r=int(f["grasp_r"][i]), grasp_l=int(f["grasp_l"][i]),
            mask=opt("mask"), depth=opt("depth"),
            right_valid=float(f["right_valid"][i]),
            left_valid=float(f["left_valid"][i]),
            is_valid=float(f["is_valid"][i]),
            joints_valid_r=f["joints_valid_r"][i],
            joints_valid_l=f["joints_valid_l"][i],
            joints3d_valid_r=opt("joints3d_valid_r"),
            joints3d_valid_l=opt("joints3d_valid_l"),
            grasp_valid_r=float(f["grasp_valid_r"][i]),
            grasp_valid_l=float(f["grasp_valid_l"][i]),
            mask_valid_r=float(f["mask_valid_r"][i]),
            mask_valid_l=float(f["mask_valid_l"][i]),
            loss_flags={k: float(f[k][i]) for k in LOSS_FLAGS},
        )
