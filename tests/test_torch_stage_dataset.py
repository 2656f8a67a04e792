"""tools/stage_dataset.py, the port's resumable dataset staging, against the
JAX package's scripts/stage_dataset.py: the six cases of
tests/test_stage_dataset.py run against the port's tool, and both tools
stage and extract the same local tars into the same trees and manifests.
Only local-path sources are exercised: gs:// and http(s):// need a
network."""

import importlib.util
import io
import json
import os
import pathlib
import sys
import tarfile

import pytest

from calm_vit_dte_tpu_torch.tools import stage_dataset

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_tool():
    """scripts/stage_dataset.py loaded by path (it imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        "jax_stage_dataset", ROOT / "scripts" / "stage_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _inner_tar(names: list[str]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in names:
            _add(tf, name, f"jpeg:{name}".encode())
    return buf.getvalue()


def _imagenet_tars(src: pathlib.Path) -> None:
    """Small stand-ins for ILSVRC2012's train tar (a tar of per-class tars),
    val tar (flat JPEGs) and devkit."""
    src.mkdir(parents=True)
    with tarfile.open(src / "ILSVRC2012_img_train.tar", "w") as tf:
        for wnid in ("n01440764", "n01443537", "n01484850"):
            _add(tf, f"{wnid}.tar", _inner_tar(
                [f"{wnid}_{i}.JPEG" for i in range(3)]))
    with tarfile.open(src / "ILSVRC2012_img_val.tar", "w") as tf:
        for i in range(1, 5):
            _add(tf, f"ILSVRC2012_val_{i:08d}.JPEG", b"val%d" % i)
    _write(str(src / "ILSVRC2012_devkit_t12.tar.gz"), b"devkit" * 100)


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != ".staged.json"}


def _manifest(dest: pathlib.Path) -> dict:
    m = json.loads((dest / ".staged.json").read_text())
    return {k: {f: v for f, v in e.items() if f != "staged"}
            for k, e in m.items()}


# The six cases of tests/test_stage_dataset.py, against the port's tool.

class TestStageFile:
    def test_local_copy_and_skip(self, tmp_path):
        src = tmp_path / "src"
        dest = tmp_path / "dest"
        src.mkdir()
        dest.mkdir()
        _write(str(src / "a.tar"), b"x" * 1000)

        manifest = {}
        assert stage_dataset.stage_file(str(src / "a.tar"),
                                        str(dest / "a.tar"), manifest)
        assert (dest / "a.tar").read_bytes() == b"x" * 1000
        assert manifest["a.tar"]["size"] == 1000
        # Second run: skipped.
        assert not stage_dataset.stage_file(str(src / "a.tar"),
                                            str(dest / "a.tar"), manifest)

    def test_restages_on_size_mismatch(self, tmp_path):
        src = tmp_path / "s.bin"
        out = tmp_path / "o.bin"
        _write(str(src), b"y" * 64)
        manifest = {"o.bin": {"size": 999}}  # stale record
        _write(str(out), b"partial")
        assert stage_dataset.stage_file(str(src), str(out), manifest)
        assert out.read_bytes() == b"y" * 64
        assert manifest["o.bin"]["size"] == 64

    def test_manifest_roundtrip(self, tmp_path):
        m = {"f": {"size": 1, "src": "s", "staged": "t"}}
        stage_dataset._save_manifest(str(tmp_path), m)
        assert stage_dataset._load_manifest(str(tmp_path)) == m
        with open(tmp_path / stage_dataset._MANIFEST) as f:
            json.load(f)  # valid json on disk


class TestExtract:
    def test_extract_val(self, tmp_path):
        tar = tmp_path / "val.tar"
        with tarfile.open(tar, "w") as tf:
            for name in ("ILSVRC2012_val_1.JPEG", "ILSVRC2012_val_2.JPEG"):
                _add(tf, name, b"jpegbytes")
        out = tmp_path / "val"
        stage_dataset.extract_val(str(tar), str(out))
        assert sorted(os.listdir(out)) == ["ILSVRC2012_val_1.JPEG",
                                           "ILSVRC2012_val_2.JPEG"]

    def test_extract_train_nested_tars(self, tmp_path):
        outer = tmp_path / "train.tar"
        with tarfile.open(outer, "w") as tf:
            _add(tf, "n01440764.tar", _inner_tar(["n01440764_1.JPEG"]))
        out = tmp_path / "train"
        stage_dataset.extract_train(str(outer), str(out))
        assert os.listdir(out / "n01440764") == ["n01440764_1.JPEG"]
        # Idempotent: re-run skips populated class dirs.
        stage_dataset.extract_train(str(outer), str(out))

    def test_extract_train_redoes_interrupted_class(self, tmp_path):
        """A class dir is populated atomically (temp dir + os.replace): an
        interruption can only leave a .staging dir, which is redone, never
        a half-full class dir that would be skipped forever."""
        outer = tmp_path / "train.tar"
        with tarfile.open(outer, "w") as tf:
            _add(tf, "n02000001.tar", _inner_tar(["a_1.JPEG", "a_2.JPEG"]))
        out = tmp_path / "train"
        # An interrupted run: leftover staging junk + an empty class dir.
        (out / "n02000001.staging").mkdir(parents=True)
        (out / "n02000001.staging" / "partial.JPEG").write_bytes(b"x")
        (out / "n02000001").mkdir()
        stage_dataset.extract_train(str(outer), str(out))
        assert sorted(os.listdir(out / "n02000001")) == ["a_1.JPEG",
                                                         "a_2.JPEG"]
        assert not (out / "n02000001.staging").exists()


# The port's tool against the JAX script.

def _run_jax(monkeypatch, argv: list[str]) -> None:
    tool = _jax_tool()
    monkeypatch.setattr(sys, "argv", ["stage_dataset.py", *argv])
    tool.main()


@pytest.mark.parametrize("extract", [False, True])
def test_same_trees_and_manifests_as_the_jax_script(tmp_path, monkeypatch,
                                                    capsys, extract):
    src = tmp_path / "src"
    _imagenet_tars(src)
    argv = ["--src", str(src)] + (["--extract"] if extract else [])
    _run_jax(monkeypatch, argv + ["--dest", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    stage_dataset.main(argv + ["--dest", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert port_tree == jax_tree
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    assert port_out.replace(str(tmp_path / "port"), "D") == \
        jax_out.replace(str(tmp_path / "jax"), "D")
    names = {"ILSVRC2012_img_train.tar", "ILSVRC2012_img_val.tar",
             "ILSVRC2012_devkit_t12.tar.gz"}
    assert names <= set(port_tree)
    if extract:
        assert port_tree["train/n01443537/n01443537_2.JPEG"] == \
            b"jpeg:n01443537_2.JPEG"
        assert sorted(k for k in port_tree if k.startswith("val/")) == [
            f"val/ILSVRC2012_val_{i:08d}.JPEG" for i in range(1, 5)]
    else:
        assert set(port_tree) == names


def test_rerun_skips_staged_files_and_restages_a_changed_one(tmp_path,
                                                             capsys):
    src = tmp_path / "src"
    _imagenet_tars(src)
    dest = tmp_path / "dest"
    argv = ["--src", str(src), "--dest", str(dest), "--extract"]
    stage_dataset.main(argv)
    capsys.readouterr()
    stage_dataset.main(argv)
    out = capsys.readouterr().out
    assert out.count("already staged") == 3 and ": staged (" not in out
    # A truncated copy (its size no longer the manifest's) is staged again.
    _write(str(dest / "ILSVRC2012_devkit_t12.tar.gz"), b"trunc")
    stage_dataset.main(argv)
    out = capsys.readouterr().out
    assert out.count("already staged") == 2
    assert "ILSVRC2012_devkit_t12.tar.gz: staged (600 bytes)" in out
    assert (dest / "ILSVRC2012_devkit_t12.tar.gz").read_bytes() == \
        b"devkit" * 100


def test_gcs_source_without_its_tools_raises(tmp_path, monkeypatch):
    """A gs:// source needs gcloud or gsutil; without them staging fails
    after its retries (no network is touched: both are reported absent)."""
    monkeypatch.setattr(stage_dataset.shutil, "which", lambda name: None)
    monkeypatch.setattr(stage_dataset.time, "sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="failed after 3 tries"):
        stage_dataset.stage_file("gs://bucket/a.tar",
                                 str(tmp_path / "a.tar"), {})
    assert not (tmp_path / "a.tar").exists()
