"""Pack the per-sequence files of ``cli.extract`` into one split-level file,
with an image-name check against the split (port of
``hands_tpu/cli/build_feat_split.py``; numpy only).

    python -m hands_tpu_torch.cli.build_feat_split --eval_p \\
        logs/extract/eval [--split_npy split.npy] [--out packed.npy]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def check_imgname_match(imgnames_feat, split_imgnames) -> None:
    """Raise unless the two sets of (suffix-normalised) image names are
    equal: guards against packing the features of another split."""
    def norm(n):
        return "/".join(n.split("/")[-4:])

    feat = {norm(n) for n in imgnames_feat}
    ref = {norm(n) for n in split_imgnames}
    if feat != ref:
        raise ValueError(f"imgname mismatch: {len(feat - ref)} extra, "
                         f"{len(ref - feat)} missing")


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--eval_p", required=True,
                   help="dir of per-seq extraction npy files")
    p.add_argument("--split_npy", default="",
                   help="optional split npy for imgname verification")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.eval_p, "*.npy")))
    if not files:
        raise FileNotFoundError(f"no extraction files under {args.eval_p}")
    imgnames, feats = [], {}
    for f in files:
        data = np.load(f, allow_pickle=True).item()
        imgnames.extend(data["imgname"])
        for k, v in data.items():
            if k.startswith("pred."):
                feats.setdefault(k, []).append(v)

    if args.split_npy:
        split = np.load(args.split_npy, allow_pickle=True).item()
        check_imgname_match(imgnames, split["imgnames"])
        print("Passed verification")

    out_p = args.out or os.path.join(args.eval_p, "packed_split.npy")
    payload = {"imgname": imgnames}
    for k, v in feats.items():
        payload[k] = np.concatenate(v, axis=0)
    np.save(out_p, payload)
    print(f"packed {len(imgnames)} samples -> {out_p}")
    return out_p


if __name__ == "__main__":
    main(sys.argv[1:])
