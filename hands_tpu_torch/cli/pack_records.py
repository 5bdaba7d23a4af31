"""Offline packer: a dataset -> memory-mapped record shards (port of
``hands_tpu/cli/pack_records.py``; the directory format is the JAX
package's, ``data/packed.py``).

Pack once, then train on the shards: build a ``PackedRecordDataset`` on the
directory and hand its loader to ``Trainer.fit``; the loader's host half
then copies rows out of the page cache and decodes no image (README).

Usage:
  python -m hands_tpu_torch.cli.pack_records --synthetic 256 --out /tmp/packed
  python -m hands_tpu_torch.cli.pack_records --method hands_light \\
      --dataset hands --split train --out /data/packed/hands_train

``--dataset`` takes a registry name or an ``a+b+c`` mix, read from
``$DATA_DIR`` (``data/datasets.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--method", default="hands_light")
    p.add_argument("--dataset", default="",
                   help="dataset registry name (e.g. hands, assembly, epic)")
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--synthetic", type=int, default=0,
                   help="pack N synthetic records instead of a real dataset")
    args = p.parse_args(argv)

    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.datasets import (SyntheticRecordDataset,
                                               fetch_dataset)
    from hands_tpu_torch.data.packed import pack_dataset

    cfg = default_config(args.method)
    if args.synthetic:
        ds = SyntheticRecordDataset(cfg, args.split, length=args.synthetic)
    else:
        ds = fetch_dataset(cfg, args.dataset or cfg.dataset, args.split)

    t0 = time.time()
    out = pack_dataset(ds, args.out, chunk=args.chunk)
    dt = time.time() - t0
    size = sum(
        os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(json.dumps({
        "packed": out, "n": len(ds), "seconds": round(dt, 1),
        "bytes": size, "records_per_sec": round(len(ds) / max(dt, 1e-9), 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
