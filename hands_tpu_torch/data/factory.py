"""Dataloader factory (port of ``hands_tpu/data/factory.py``): split
resolution and the train and val loaders."""

from __future__ import annotations

import numpy as np

from hands_tpu_torch.config import Config
from hands_tpu_torch.data.datasets import fetch_dataset
from hands_tpu_torch.data.device_pipeline import (DeviceDataLoader,
                                                  PrefetchLoader)

# meta keys carried as python lists, not arrays
_LIST_KEYS = ("imgname", "query_names")


def collate_windowed(data_list):
    """Temporal-window concat collate: each sample is an (inputs, targets,
    meta_info) triple whose arrays already carry a leading window axis;
    samples are CONCATENATED along axis 0 (window frames become batch rows),
    except the list-valued meta keys (imgname, query_names), which are
    summed. No shipped config turns the temporal path on; the contract is
    kept so that windowed datasets plug in without touching the loader."""
    def cat(vals, listlike=False):
        if listlike:
            return sum((list(v) for v in vals), [])
        return np.concatenate([np.asarray(v) for v in vals], axis=0)

    outs = []
    for part_idx in range(3):
        keys = data_list[0][part_idx].keys()
        is_meta = part_idx == 2
        outs.append({
            k: cat([d[part_idx][k] for d in data_list],
                   listlike=is_meta and k in _LIST_KEYS)
            for k in keys})
    return tuple(outs)


def fetch_dataloader(cfg: Config, mode: str, device="cuda", shard=(0, 1)):
    """The loader of ``mode`` (``train``; ``val``, ``eval`` or ``test``) with
    its batches preprocessed on ``device``. The train loader prefetches on a
    background thread when ``cfg.num_workers > 0``. ``shard``: (this rank's
    coordinate on the mesh's ``"data"`` axis, the axis' size), the
    ``Trainer``'s ``data_shard``; the loader yields that coordinate's rows of
    every global batch (all of them on a data axis of 1, replicated over the
    other axes, as in JAX)."""
    if mode == "train":
        dataset = fetch_dataset(cfg, cfg.dataset, cfg.trainsplit)
        loader = DeviceDataLoader(
            dataset, cfg, cfg.batch_size, is_train=True, seed=cfg.seed,
            shard=shard, device=device)
        return PrefetchLoader(loader) if cfg.num_workers > 0 else loader
    if mode in ("val", "eval", "test"):
        split = cfg.valsplit if mode == "val" else "test"
        dataset = fetch_dataset(cfg, cfg.val_dataset, split)
        return DeviceDataLoader(
            dataset, cfg, cfg.test_batch_size, is_train=False, seed=cfg.seed,
            drop_last=False, shard=shard, device=device)
    raise ValueError(f"unknown mode '{mode}'")
