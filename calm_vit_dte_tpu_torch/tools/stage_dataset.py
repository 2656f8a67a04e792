"""Stage the ImageNet dataset onto local disk (resumable).

Port of scripts/stage_dataset.py (the JAX package's staging script), line
for line: the same manifest (`<dest>/.staged.json`), sources, retries and
extraction; nothing here is device code. It replaces the reference's
dataset-staging pod (reference: Deployments/dataset_downloader.yaml:34-45),
which cp'd ILSVRC2012_img_{train,val}.tar + the devkit between two CephFS
PVCs.

Sources per file may be
  * local/NFS paths         (the reference's case: PVC -> PVC copy)
  * gs://bucket/...         (via gsutil/gcloud storage when installed)
  * http(s)://...           (stdlib urllib, resumed with Range)

Resumability: a completed file is recorded with its byte size in
<dest>/.staged.json and skipped on re-run; partial HTTP downloads resume
from the current byte offset; partial local/GCS copies restart (both are
fast LAN copies). Optional --extract unpacks the train/val tars the way
torchvision's ImageNet parser expects them on disk: train/<wnid>/*.JPEG,
the layout data/loader.py::ImageFolderDataset reads, and the flat val/.

Usage:
  python -m calm_vit_dte_tpu_torch.tools.stage_dataset \
      --src /config/imagenet --dest /dataset/imagenet [--extract]
  python -m calm_vit_dte_tpu_torch.tools.stage_dataset \
      --src gs://my-bucket/imagenet --dest /dataset/imagenet \
      --files ILSVRC2012_img_val.tar
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tarfile
import time
import urllib.request

DEFAULT_FILES = [
    "ILSVRC2012_img_train.tar",
    "ILSVRC2012_img_val.tar",
    "ILSVRC2012_devkit_t12.tar.gz",
]
_MANIFEST = ".staged.json"
_CHUNK = 16 * 1024 * 1024


def _load_manifest(dest: str) -> dict:
    path = os.path.join(dest, _MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_manifest(dest: str, manifest: dict) -> None:
    path = os.path.join(dest, _MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)


def _copy_local(src: str, out: str) -> None:
    tmp = out + ".partial"
    shutil.copyfile(src, tmp)
    os.replace(tmp, out)


def _copy_gcs(src: str, out: str) -> None:
    for tool in (["gcloud", "storage", "cp"], ["gsutil", "cp"]):
        if shutil.which(tool[0]):
            tmp = out + ".partial"
            subprocess.run(tool + [src, tmp], check=True)
            os.replace(tmp, out)
            return
    raise RuntimeError(
        "gs:// source but neither `gcloud` nor `gsutil` is installed")


def _copy_http(src: str, out: str) -> None:
    tmp = out + ".partial"
    offset = os.path.getsize(tmp) if os.path.exists(tmp) else 0
    req = urllib.request.Request(src)
    if offset:
        req.add_header("Range", f"bytes={offset}-")
    with urllib.request.urlopen(req) as resp:
        if offset and resp.status != 206:  # server ignored Range: restart
            offset = 0
        mode = "ab" if offset else "wb"
        with open(tmp, mode) as f:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                f.write(chunk)
    os.replace(tmp, out)


def stage_file(src: str, out: str, manifest: dict, retries: int = 3) -> bool:
    """Fetch one file; returns True if it was (re)staged, False if skipped."""
    name = os.path.basename(out)
    if (name in manifest and os.path.exists(out)
            and os.path.getsize(out) == manifest[name]["size"]):
        print(f"  {name}: already staged ({manifest[name]['size']} bytes)")
        return False
    last = None
    for attempt in range(retries):
        try:
            if src.startswith("gs://"):
                _copy_gcs(src, out)
            elif src.startswith(("http://", "https://")):
                _copy_http(src, out)
            else:
                _copy_local(src, out)
            break
        except Exception as e:  # noqa: BLE001 — retry any transport error
            last = e
            print(f"  {name}: attempt {attempt + 1} failed: {e}",
                  file=sys.stderr)
            time.sleep(min(2.0 ** attempt, 30.0))
    else:
        raise RuntimeError(f"staging {src} failed after {retries} tries: "
                           f"{last}")
    manifest[name] = {"size": os.path.getsize(out), "src": src,
                      "staged": time.strftime("%Y-%m-%dT%H:%M:%S")}
    print(f"  {name}: staged ({manifest[name]['size']} bytes)")
    return True


def extract_train(tar_path: str, out_dir: str) -> None:
    """ILSVRC2012_img_train.tar is a tar of 1000 per-class tars; unpack to
    out_dir/<wnid>/*.JPEG (torchvision ImageNet layout)."""
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(tar_path) as outer:
        for member in outer:
            if not member.name.endswith(".tar"):
                continue
            wnid = member.name[:-4]
            cls_dir = os.path.join(out_dir, wnid)
            if os.path.isdir(cls_dir) and os.listdir(cls_dir):
                continue
            # Extract to a temp dir, then rename into place: a class dir
            # only ever appears complete, so an interrupted extraction is
            # redone on resume instead of being skipped half-full.
            tmp_dir = cls_dir + ".staging"
            if os.path.isdir(tmp_dir):
                shutil.rmtree(tmp_dir)
            os.makedirs(tmp_dir)
            inner_f = outer.extractfile(member)
            with tarfile.open(fileobj=inner_f) as inner:
                inner.extractall(tmp_dir, filter="data")
            if os.path.isdir(cls_dir):  # existed but empty
                os.rmdir(cls_dir)
            os.replace(tmp_dir, cls_dir)
            print(f"  extracted {wnid}")


def extract_val(tar_path: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(tar_path) as tf:
        tf.extractall(out_dir, filter="data")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="source prefix: dir, gs://..., or http(s)://...")
    ap.add_argument("--dest", required=True, help="local destination dir")
    ap.add_argument("--files", nargs="*", default=DEFAULT_FILES,
                    help=f"files to stage (default: {DEFAULT_FILES})")
    ap.add_argument("--extract", action="store_true",
                    help="unpack train/val tars into torchvision layout")
    args = ap.parse_args(argv)

    os.makedirs(args.dest, exist_ok=True)
    manifest = _load_manifest(args.dest)
    print(f"staging {len(args.files)} file(s): {args.src} -> {args.dest}")
    for name in args.files:
        src = args.src.rstrip("/") + "/" + name
        stage_file(src, os.path.join(args.dest, name), manifest)
        _save_manifest(args.dest, manifest)

    if args.extract:
        train_tar = os.path.join(args.dest, "ILSVRC2012_img_train.tar")
        val_tar = os.path.join(args.dest, "ILSVRC2012_img_val.tar")
        if os.path.exists(train_tar):
            extract_train(train_tar, os.path.join(args.dest, "train"))
        if os.path.exists(val_tar):
            extract_val(val_tar, os.path.join(args.dest, "val"))
    print("dataset staged successfully")


if __name__ == "__main__":
    main()
