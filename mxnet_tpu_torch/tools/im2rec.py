"""Pack an image folder into RecordIO (the port of the JAX package's
tools/im2rec.py, after the reference's tools/im2rec.py).

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list --recursive
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--resize N]

The same two phases: `--list` walks ROOT and writes PREFIX.lst (index,
label, path a line; with --recursive the first folder level names the
label), then the default mode packs the listed images into PREFIX.rec
and PREFIX.idx through the port's `recordio`, which `mx.io.ImageRecordIter`,
`mx.image.ImageIter` and `ImageRecordDataset` read. JPEG, PNG and BMP
files are decoded with PIL, resized (--resize: the shorter side) and
re-encoded as JPEG; with --pass-through, or where PIL is not installed,
their bytes are packed as they are. ``.npy`` files (an HWC uint8 array
each) need no codec: they are packed as the `.npy` payload that
`recordio.pack_img` writes, resized with the port's bilinear filter.
For a folder without ``.npy`` files the three files are byte-identical
to the JAX package's tool's.
"""
from __future__ import annotations

import argparse
import io
import os
import random
import sys

from mxnet_tpu_torch import recordio

EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


def list_images(root, recursive):
    cat = {}
    items = []
    i = 0
    if recursive:
        for path, _, files in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(files):
                if fname.lower().endswith(EXTS):
                    label_dir = os.path.relpath(path, root).split(os.sep)[0]
                    if label_dir not in cat:
                        cat[label_dir] = len(cat)
                    items.append((i, os.path.relpath(
                        os.path.join(path, fname), root), cat[label_dir]))
                    i += 1
        for k in sorted(cat):
            print("%s %d" % (k, cat[k]))
    else:
        for fname in sorted(os.listdir(root)):
            if fname.lower().endswith(EXTS):
                items.append((i, fname, 0))
                i += 1
    return items


def write_list(path_out, items):
    with open(path_out, "w") as fout:
        for idx, rel, label in items:
            fout.write("%d\t%f\t%s\n" % (idx, label, rel))


def read_list(path_in):
    with open(path_in) as fin:
        for line in fin:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            # reference format: idx \t label(s)... \t relpath
            yield (int(float(parts[0])),
                   [float(x) for x in parts[1:-1]], parts[-1])


def _encode_npy(path, args):
    """A .npy image's payload: its array, the shorter side resized to
    --resize (int(side * scale), as for JPEG) with antialiased
    bilinear."""
    import numpy as np
    import torch
    img = np.load(path, allow_pickle=False)
    if args.resize:
        h, w = img.shape[:2]
        scale = args.resize / min(w, h)
        t = torch.from_numpy(np.ascontiguousarray(img)).reshape(h, w, -1)
        out = torch.nn.functional.interpolate(
            t.permute(2, 0, 1)[None].float(),
            size=(max(1, int(h * scale)), max(1, int(w * scale))),
            mode="bilinear", align_corners=False, antialias=True)[0]
        out = out.round_().clamp_(0, 255).to(t.dtype).permute(1, 2, 0)
        img = out.reshape(out.shape[:2] + img.shape[2:]).numpy()
    buf = io.BytesIO()
    np.save(buf, img, allow_pickle=False)
    return buf.getvalue()


def _encode_image(path, args):
    if path.lower().endswith(".npy"):
        return _encode_npy(path, args)
    if args.pass_through:
        with open(path, "rb") as f:
            return f.read()
    try:
        from PIL import Image
    except ImportError:
        # no codec: the file's own JPEG/PNG/BMP bytes
        with open(path, "rb") as f:
            return f.read()
    img = Image.open(path).convert("RGB")
    if args.resize:
        w, h = img.size
        scale = args.resize / min(w, h)
        img = img.resize((max(1, int(w * scale)),
                          max(1, int(h * scale))))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=args.quality)
    return buf.getvalue()


def make_record(args, lst_path):
    prefix = os.path.splitext(lst_path)[0]
    record = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    count = 0
    for idx, labels, rel in read_list(lst_path):
        fullpath = os.path.join(args.root, rel)
        try:
            payload = _encode_image(fullpath, args)
        except (OSError, SystemExit) as e:
            print("imread error, skipping %s: %s" % (rel, e),
                  file=sys.stderr)
            continue
        label = labels[0] if len(labels) == 1 else labels
        header = recordio.IRHeader(0, label, idx, 0)
        record.write_idx(idx, recordio.pack(header, payload))
        count += 1
        if count % 1000 == 0:
            print("processed %d images" % count)
    record.close()
    print("wrote %d records to %s.rec" % (count, prefix))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("prefix", help=".lst path prefix (or output prefix "
                                       "with --list)")
    parser.add_argument("root", help="image root directory")
    parser.add_argument("--list", action="store_true",
                        help="create a .lst instead of packing")
    parser.add_argument("--recursive", action="store_true",
                        help="walk subdirectories; dir names become labels")
    parser.add_argument("--shuffle", type=int, default=1)
    parser.add_argument("--resize", type=int, default=0,
                        help="resize shorter edge")
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--pass-through", action="store_true",
                        help="pack original file bytes, no re-encode")
    args = parser.parse_args()

    if args.list:
        items = list_images(args.root, args.recursive)
        if args.shuffle:
            random.seed(100)
            random.shuffle(items)
            items = [(i, rel, lab) for i, (_, rel, lab) in enumerate(items)]
        write_list(args.prefix + ".lst", items)
        print("wrote %d entries to %s.lst" % (len(items), args.prefix))
        return

    lst = args.prefix if args.prefix.endswith(".lst") else \
        args.prefix + ".lst"
    if not os.path.isfile(lst):
        raise SystemExit("list file %s not found; run with --list first"
                         % lst)
    make_record(args, lst)


if __name__ == "__main__":
    main()
