#!/usr/bin/env python
"""Write BasicSR-style meta_info files for the video and paired datasets.

A copy of ``scripts/make_meta_info.py``: REDS from its published structure,
Vimeo90K from the ``sep_*list.txt`` files of its download, or any
clip-per-folder dataset by scanning it (OpenCV reads the first frame's
shape, and only there).

Usage:
  python -m tpuir_torch.scripts.make_meta_info reds          > meta_info_REDS_GT.txt
  python -m tpuir_torch.scripts.make_meta_info reds4         > meta_info_REDS4_test_GT.txt
  python -m tpuir_torch.scripts.make_meta_info redsofficial4 > meta_info_REDSofficial4_test_GT.txt
  python -m tpuir_torch.scripts.make_meta_info redsval       > meta_info_REDSval_official_test_GT.txt
  python -m tpuir_torch.scripts.make_meta_info vimeo --list sep_trainlist.txt \
      > meta_info_Vimeo90K_train_GT.txt
  python -m tpuir_torch.scripts.make_meta_info scan --root /data/myset [--ext png] \
      > meta_info_myset_GT.txt
"""

from __future__ import annotations

import argparse
import os
import sys

# REDS: 270 train clips 000-269, 100 frames each, 720x1280 RGB.
# REDS4 (the validation split carved out of train, data/__init__ docs):
REDS4 = ["000", "011", "015", "020"]
# the official validation clips are renumbered 240-269 when merged with
# train (realDenoising/basicsr/data/reds_dataset.py val_partition docs)
REDS_OFFICIAL4 = ["240", "241", "246", "257"]
REDS_SHAPE = "(720,1280,3)"


def reds_lines(clips):
    return [f"{c} 100 {REDS_SHAPE}" for c in clips]


def vimeo_lines(list_path: str):
    out = []
    with open(list_path) as f:
        for line in f:
            clip = line.strip()
            if clip:
                out.append(f"{clip} 7 (256,448,3)")
    return out


def scan_lines(root: str, ext: str = "png"):
    """clip-per-subfolder layout: emits 'clip n_frames (h,w,c)'."""
    out = []
    for clip in sorted(os.listdir(root)):
        cdir = os.path.join(root, clip)
        if not os.path.isdir(cdir):
            continue
        frames = [f for f in os.listdir(cdir) if f.endswith("." + ext)]
        if not frames:
            continue
        import cv2

        img = cv2.imread(os.path.join(cdir, sorted(frames)[0]))
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        out.append(f"{clip} {len(frames)} ({h},{w},{c})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=["reds", "reds4", "redsofficial4",
                                     "redsval", "vimeo", "scan"])
    ap.add_argument("--list", dest="list_path",
                    help="vimeo: path to sep_trainlist.txt / sep_testlist.txt")
    ap.add_argument("--root", help="scan: dataset root (clip folders)")
    ap.add_argument("--ext", default="png")
    args = ap.parse_args(argv)

    if args.kind == "reds":
        lines = reds_lines([f"{i:03d}" for i in range(270)])
    elif args.kind == "reds4":
        lines = reds_lines(REDS4)
    elif args.kind == "redsofficial4":
        lines = reds_lines(REDS_OFFICIAL4)
    elif args.kind == "redsval":
        lines = reds_lines([f"{i:03d}" for i in range(240, 270)])
    elif args.kind == "vimeo":
        if not args.list_path:
            ap.error("vimeo requires --list sep_trainlist.txt")
        lines = vimeo_lines(args.list_path)
    else:
        if not args.root:
            ap.error("scan requires --root")
        lines = scan_lines(args.root, args.ext)
    sys.stdout.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
