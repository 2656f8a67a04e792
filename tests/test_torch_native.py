"""The port's native data plane (data/native.py, built from
native/decoder.cpp into build/torch_native/) against the JAX package's
`native` module: byte-equal outputs; a file it cannot decode is reported and
decoded by Pillow; the loader picks native by default and Pillow under
CALM_NATIVE_DECODE=0; a failed build says why."""

import json

import numpy as np
import pytest
from PIL import Image

from calm_vit_dte_tpu.data import native as jax_native
from calm_vit_dte_tpu_torch.data import loader, native


def _need_both():
    # As tests/test_native.py: the JAX package's library is the oracle.
    if not jax_native.available():
        pytest.skip("the JAX package's native data plane is not built")
    assert native.available(), native.unavailable_reason()


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """tests/test_native.py's image (37x53 noise upsampled to 530x370,
    quality 95) and two random shapes."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(img).resize((530, 370),
                                                 Image.BILINEAR))
    out = []
    for name, arr in (("a", img),
                      ("b", rng.integers(0, 256, (301, 117, 3), np.uint8)),
                      ("c", rng.integers(0, 256, (64, 480, 3), np.uint8))):
        Image.fromarray(arr).save(d / f"{name}.jpg", quality=95)
        out.append((str(d / f"{name}.jpg"), arr))
    return out


def test_library_builds_into_the_ports_build_dir():
    _need_both()
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.parent.name == "torch_native"
    assert native.LIB_PATH.parent.parent.name == "build"
    assert native.unavailable_reason() is None
    (first, linked, command), *_ = native.build_commands(native.LIB_PATH)
    # scripts/build_native.sh's command first.
    assert first == "system libjpeg" and linked is None
    assert command == ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                       "-march=native", "-o", str(native.LIB_PATH),
                       str(native.SRC), "-ljpeg", "-lpthread"]
    assert native.libjpeg() in ("system libjpeg",
                                native.build_commands(native.LIB_PATH)[-1][0])


def _fresh_build(tmp_path, monkeypatch):
    """Point the module at a build directory of its own, unloaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "out" / "lib.so")
    monkeypatch.setattr(native, "_STAMP", tmp_path / "out" / "lib.stamp")
    monkeypatch.setattr(native, "_state", native._Native())


def test_rebuilt_when_the_linked_libjpeg_is_gone(tmp_path, monkeypatch):
    """A library linking a libjpeg by path is stale once that file is gone
    or is no longer the one Pillow carries; one linking the system's is
    not."""
    _fresh_build(tmp_path, monkeypatch)
    native.BUILD_DIR.mkdir(parents=True)
    native.LIB_PATH.write_bytes(b"")
    stamp = {"host": native._host_id(), "libjpeg": "system libjpeg",
             "linked": None}
    native._STAMP.write_text(json.dumps(stamp))
    assert not native._stale()
    for linked in (tmp_path / "gone" / "libjpeg-0.so.62", native.SRC):
        stamp["linked"] = str(linked)
        native._STAMP.write_text(json.dumps(stamp))
        assert native._stale(), linked


def test_rebuilt_once_when_the_library_no_longer_loads(jpegs, tmp_path,
                                                       monkeypatch):
    """A library whose stamp is current but which no longer loads (as
    when the libjpeg it links has moved) is rebuilt once, and works."""
    _need_both()
    _fresh_build(tmp_path, monkeypatch)
    native.BUILD_DIR.mkdir(parents=True)
    native.LIB_PATH.write_bytes(b"not a shared object")
    native._STAMP.write_text(json.dumps({
        "host": native._host_id(), "libjpeg": "system libjpeg",
        "linked": None}))
    assert not native._stale()
    assert native.available(), native.unavailable_reason()
    paths = [p for p, _ in jpegs]
    imgs, ok = native.decode_resize_batch(paths, 96)
    want, _ = jax_native.decode_resize_batch(paths, 96)
    assert ok.all()
    np.testing.assert_array_equal(imgs, want)


def test_pillow_libjpeg_build_is_byte_equal_to_jax(jpegs, tmp_path,
                                                    monkeypatch):
    """The second command (the headers in libjpeg62/ and the libjpeg-turbo
    Pillow's wheel carries, for hosts with no libjpeg development files)
    decodes byte for byte as the JAX package's library."""
    _need_both()
    commands = native.build_commands(native.LIB_PATH)
    if len(commands) < 2:
        pytest.skip("Pillow's wheel carries no libjpeg here")
    _fresh_build(tmp_path, monkeypatch)
    build_commands = native.build_commands
    monkeypatch.setattr(native, "build_commands",
                        lambda out: build_commands(out)[1:])
    assert native.available(), native.unavailable_reason()
    assert native.libjpeg().startswith("Pillow's libjpeg-turbo")
    paths = [p for p, _ in jpegs]
    for out_size in (256, 96):
        imgs, ok = native.decode_resize_batch(paths, out_size)
        want, _ = jax_native.decode_resize_batch(paths, out_size)
        assert ok.all()
        np.testing.assert_array_equal(imgs, want)


@pytest.mark.parametrize("out_size", [256, 224, 64])
def test_resize_rgb_is_byte_equal_to_jax(jpegs, out_size):
    _need_both()
    for _, img in jpegs:
        np.testing.assert_array_equal(native.resize_rgb(img, out_size),
                                      jax_native.resize_rgb(img, out_size))


@pytest.mark.parametrize("out_size,n_threads", [(128, None), (96, 1)])
def test_decode_resize_batch_is_byte_equal_to_jax(jpegs, out_size,
                                                  n_threads):
    _need_both()
    paths = [p for p, _ in jpegs] * 2
    imgs, ok = native.decode_resize_batch(paths, out_size, n_threads)
    want, want_ok = jax_native.decode_resize_batch(paths, out_size,
                                                   n_threads)
    assert ok.all() and want_ok.all()
    assert imgs.shape == (6, out_size, out_size, 3)
    np.testing.assert_array_equal(imgs, want)
    # tests/test_native.py:46: within 2 of Pillow.
    pil = np.asarray(Image.open(paths[0]).convert("RGB").resize(
        (out_size, out_size), Image.BILINEAR))
    assert np.abs(imgs[0].astype(int) - pil.astype(int)).max() <= 2


def _folder(root):
    cls = root / "train" / "class_a"
    cls.mkdir(parents=True)
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    Image.fromarray(img).save(cls / "good.jpeg")
    Image.fromarray(img).save(cls / "png_one.png")   # native cannot
    Image.fromarray(img).convert("CMYK").save(cls / "x_cmyk.jpg")   # nor
    (cls / "zbad.jpg").write_bytes(b"not a jpeg")
    return loader.ImageFolderDataset(str(root), split="train", size=32)


def test_bad_files_are_reported_and_decoded_by_pillow(tmp_path,
                                                      monkeypatch):
    _need_both()
    ds = _folder(tmp_path)
    paths = [p for p, _ in ds.samples]
    _, ok = native.decode_resize_batch(paths, 32)
    _, want_ok = jax_native.decode_resize_batch(paths, 32)
    assert ok.tolist() == want_ok.tolist() == [True, False, False, False]
    monkeypatch.delenv("CALM_NATIVE_DECODE", raising=False)
    imgs, labels = ds.load_batch([0, 1, 2])
    assert ds.decoder == "native" and ds.decoder_reason is None
    assert ds.pillow_images == 2           # the PNG and the CMYK JPEG
    assert imgs.shape == (3, 32, 32, 3) and (labels == 0).all()
    for j in (1, 2):
        np.testing.assert_array_equal(imgs[j], ds.load(j)[0])
        assert imgs[j].std() > 0
    with pytest.raises(OSError):
        ds.load_batch([3])                 # not an image for Pillow either


def test_loader_decoder_switch(tmp_path, monkeypatch):
    _need_both()
    ds = _folder(tmp_path)
    monkeypatch.delenv("CALM_NATIVE_DECODE", raising=False)
    native_imgs, _ = ds.load_batch([0])
    assert (ds.decoder, ds.pillow_images) == ("native", 0)
    np.testing.assert_array_equal(
        native_imgs[0], native.decode_resize_batch([ds.samples[0][0]],
                                                   32)[0][0])
    monkeypatch.setenv("CALM_NATIVE_DECODE", "0")
    pil_imgs, _ = ds.load_batch([0])
    assert ds.decoder == "pillow"
    assert ds.decoder_reason == "CALM_NATIVE_DECODE=0"
    assert ds.pillow_images == 1
    np.testing.assert_array_equal(pil_imgs[0], ds.load(0)[0])
    assert np.abs(native_imgs.astype(int) - pil_imgs.astype(int)).max() <= 2


def test_failed_build_is_reported(tmp_path, monkeypatch):
    src = tmp_path / "decoder.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    _fresh_build(tmp_path, monkeypatch)
    assert not native.available() and native.libjpeg() is None
    reason = native.unavailable_reason()
    assert "native decoder unavailable" in reason
    assert "decoder.cpp" in reason          # the compiler's own message
    assert "[system libjpeg]" in reason
    assert "[Pillow's libjpeg-turbo" in reason
    with pytest.raises(RuntimeError, match="unavailable"):
        native.resize_rgb(np.zeros((4, 4, 3), np.uint8), 2)
    monkeypatch.delenv("CALM_NATIVE_DECODE", raising=False)
    ds = _folder(tmp_path / "data")
    imgs, _ = ds.load_batch([0, 1])        # the whole batch by Pillow
    assert ds.decoder == "pillow" and ds.decoder_reason == reason
    assert ds.pillow_images == 2
    np.testing.assert_array_equal(imgs[0], ds.load(0)[0])
