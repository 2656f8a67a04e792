"""ctypes binding of the native data plane (native/decoder.cpp).

JAX counterpart: calm_vit_dte_tpu/data/native.py, with the same API
(`available`, `decode_resize_batch`, `resize_rgb`). `decode_resize_batch`
releases the GIL for the whole batch: JPEG decode and a Pillow-compatible
antialiased resize run on C++ threads. Images the native path cannot handle
(PNG, CMYK JPEG, truncated files) come back with ok=False, and the caller
decodes those with Pillow (data/loader.py).

The port builds its own library from the repository's top-level
native/decoder.cpp, at first use, into build/torch_native/libcalmdata.so,
with the command of scripts/build_native.sh (`-march=native` included: the
resize's rounding differs by up to 1 without it), linking the host's
libjpeg. That command comes first because it is the JAX package's: both
libraries then link the same libjpeg, and so decode with the same IDCT, on
any host that has libjpeg's development files. Where the host has none (the
H100 host), it compiles with the same flags against the libjpeg API-62
headers kept in libjpeg62/ and links, by its path, the libjpeg-turbo (API
62) that Pillow's wheel carries, the library Pillow itself decodes with;
`libjpeg()` says which was linked. It never loads or rebuilds the JAX
package's copy. The library is rebuilt when the source is newer, when it
was built on another kind of host (`-march=native` code may not run
there), when the libjpeg it links by path is gone or is no longer the one
Pillow carries, and once, when it no longer loads. A failed build keeps the
compiler's messages: `available()` is then False and `unavailable_reason()`
says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "decoder.cpp"
INCLUDE_62 = pathlib.Path(__file__).resolve().parent / "libjpeg62"
BUILD_DIR = _ROOT / "build" / "torch_native"
LIB_PATH = BUILD_DIR / "libcalmdata.so"
_STAMP = BUILD_DIR / "libcalmdata.stamp"
_FLAGS = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]


def _pillow_libjpeg() -> pathlib.Path | None:
    """The libjpeg-turbo Pillow's wheel carries (pillow.libs/), if any."""
    try:
        import PIL
    except ImportError:
        return None
    libs = sorted((pathlib.Path(PIL.__file__).resolve().parent.parent
                   / "pillow.libs").glob("libjpeg-*.so*"))
    return libs[0] if libs else None


def build_commands(out: pathlib.Path) -> list[tuple]:
    """(libjpeg linked, the file it links by path or None, g++ command
    writing `out`), in the order tried: scripts/build_native.sh's command;
    then, where Pillow's wheel carries libjpeg-turbo, the same flags
    against it and the headers in libjpeg62/."""
    commands = [("system libjpeg", None,
                 _FLAGS + ["-o", str(out), str(SRC), "-ljpeg",
                           "-lpthread"])]
    pil = _pillow_libjpeg()
    if pil is not None:
        commands.append((
            f"Pillow's libjpeg-turbo ({pil.name})", pil,
            _FLAGS + ["-I", str(INCLUDE_62), "-o", str(out), str(SRC),
                      str(pil), f"-Wl,-rpath,{pil.parent}", "-lpthread"]))
    return commands


def _host_id() -> str:
    """The build flags and this host's CPU features: a library built with
    -march=native is reused only on a host that has them all."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f
                          if line.startswith(("flags", "Features"))), "")
    except OSError:
        flags = ""
    text = " ".join(_FLAGS) + platform.machine() + flags
    return hashlib.sha256(text.encode()).hexdigest()


class _Native:
    """The process's one library: loaded (or found unavailable) once, under
    a lock, since the loader's worker threads may all ask at once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: ctypes.CDLL | None = None
        self.reason: str | None = None   # why the library is unavailable
        self.tried = False


_state = _Native()


def _build() -> None:
    """Compile into a temporary file and rename it into place, so a process
    loading the library concurrently sees the old one or the new one. Tries
    `build_commands` in turn; raises with every compiler message when none
    builds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    failures = []
    for libjpeg, linked, command in build_commands(tmp):
        try:
            proc = subprocess.run(command, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            failures.append(f"[{libjpeg}] g++ did not run: {exc}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, LIB_PATH)
            _STAMP.write_text(json.dumps({
                "host": _host_id(), "libjpeg": libjpeg,
                "linked": None if linked is None else str(linked)}))
            return
        tmp.unlink(missing_ok=True)
        failures.append(f"[{libjpeg}] g++ exited {proc.returncode}:\n"
                        f"{(proc.stdout + proc.stderr).strip()}")
    if len(failures) == 1:
        failures.append("[Pillow's libjpeg-turbo] not tried: Pillow's "
                        "wheel carries no libjpeg")
    raise RuntimeError("\n".join(failures))


def _stamp() -> dict:
    try:
        return json.loads(_STAMP.read_text())
    except (OSError, ValueError):
        return {}


def _stale() -> bool:
    stamp = _stamp()
    linked = stamp.get("linked")
    return (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime
            or stamp.get("host") != _host_id()
            or (linked is not None
                and (not pathlib.Path(linked).exists()
                     or pathlib.Path(linked) != _pillow_libjpeg())))


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if missing or stale; None (with
    `unavailable_reason()`) when it cannot be built or loaded."""
    with _state.lock:
        if not _state.tried:
            _state.tried = True
            try:
                _state.lib = _load()
            except (RuntimeError, OSError) as exc:
                _state.reason = f"native decoder unavailable: {exc}"
    return _state.lib


def _load() -> ctypes.CDLL:
    built = _stale()
    if built:
        _build()
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        if built:
            raise
        _build()   # a library that no longer loads: rebuild it once
        lib = ctypes.CDLL(str(LIB_PATH))
    lib.decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.decode_resize_batch.restype = None
    lib.resize_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.resize_rgb.restype = None
    return lib


def available() -> bool:
    return get_lib() is not None


def libjpeg() -> str | None:
    """Which libjpeg the loaded library links (None if unavailable)."""
    return _stamp().get("libjpeg") if available() else None


def unavailable_reason() -> str | None:
    """None when the library loaded; otherwise the build's or the loader's
    message (g++ or libjpeg missing, a compile error)."""
    get_lib()
    return _state.reason


def _lib_or_raise() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(_state.reason)
    return lib


def decode_resize_batch(paths: list[str], out_size: int,
                        n_threads: int | None = None):
    """Returns (images uint8 (N, out, out, 3), ok bool (N,)). Failed entries
    have ok=False and undefined pixels: decode those with Pillow.

    n_threads defaults to the host's cores, capped at the batch size."""
    if n_threads is None:
        n_threads = max(1, min(os.cpu_count() or 8, len(paths)))
    if n_threads < 1 or out_size < 1:
        raise ValueError(f"n_threads {n_threads} and out_size {out_size} "
                         "must be positive")
    lib = _lib_or_raise()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_resize_batch(
        arr, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    return out, ok.astype(bool)


def resize_rgb(img: np.ndarray, out_size: int) -> np.ndarray:
    """Antialiased bilinear resize of one RGB uint8 image (testing hook)."""
    lib = _lib_or_raise()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    out = np.empty((out_size, out_size, 3), np.uint8)
    lib.resize_rgb(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                   w, h, out_size,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
