#!/usr/bin/env python
"""Build an lmdb database from an image folder: a copy of
``scripts/create_lmdb.py``.

Writes BasicSR's lmdb layout, data.mdb and lock.mdb plus meta_info.txt with
"name.png (h,w,c) compress_level" lines, which the lmdb ``FileClient``
backend reads. Needs the optional lmdb package (and OpenCV); without lmdb
it says so and returns 1.

  python -m tpuir_torch.scripts.create_lmdb --input datasets/.../train --output x.lmdb
"""

import argparse
import os
import sys
from glob import glob

from tpuir_torch.utils.natsort import natsorted


def make_lmdb_from_folder(input_dir: str, output_path: str, compress_level: int = 1):
    try:
        import lmdb
    except ImportError:
        print("the lmdb package is not installed; `pip install lmdb` first")
        return 1
    import cv2

    paths = natsorted(glob(os.path.join(input_dir, "*.*")))
    if not paths:
        print(f"no images under {input_dir}")
        return 1

    nbytes = sum(os.path.getsize(p) for p in paths)
    env = lmdb.open(output_path, map_size=nbytes * 10)
    meta = []
    with env.begin(write=True) as txn:
        for path in paths:
            key = os.path.splitext(os.path.basename(path))[0]
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            h, w = img.shape[:2]
            c = 1 if img.ndim == 2 else img.shape[2]
            ok, buf = cv2.imencode(
                ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level]
            )
            assert ok
            txn.put(key.encode("ascii"), buf.tobytes())
            meta.append(f"{key}.png ({h},{w},{c}) {compress_level}")
    with open(os.path.join(output_path, "meta_info.txt"), "w") as f:
        f.write("\n".join(meta) + "\n")
    print(f"wrote {len(paths)} entries to {output_path}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--compress-level", type=int, default=1)
    args = ap.parse_args()
    return make_lmdb_from_folder(args.input, args.output, args.compress_level)


if __name__ == "__main__":
    sys.exit(main())
