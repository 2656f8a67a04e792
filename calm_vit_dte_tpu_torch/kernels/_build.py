"""Build the CUDA sources in csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on its own into
`build/torch_kernels/lib<name>.so` (beside the package, under the repo's
git-ignored `build/`), for sm_90a, with a plain C interface. A library is
built at first use and rebuilt when its source (or a shared `csrc/*.cuh`
header) is newer; nothing is compiled
when a module is imported. `build()` starts one nvcc per source at once, so
building every kernel costs the time of the slowest one. Under
torch.distributed, `build_once_per_host` builds on each host's local rank
0 alone.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def _paths(name: str) -> tuple[Path, Path, Path]:
    return (CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so",
            BUILD_DIR / f"lib{name}.ptxas.txt")


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    src, lib, _ = _paths(name)
    newest = max(f.stat().st_mtime for f in [src, *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def build(names: list[str]) -> dict[str, str]:
    """Compile the named sources that are missing or stale, one nvcc each,
    all started together. Returns {name: nvcc/ptxas output} for every name
    (read back from the log of an earlier build when nothing was stale)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, lib, _ = _paths(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _, lib, log = _paths(name)
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _paths(name)[2].read_text() for name in names}


def sources() -> list[str]:
    """The names of every csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_once_per_host(names: list[str]) -> None:
    """Under torch.distributed, local rank 0 builds the named sources while
    the host's other ranks wait at a barrier, then every rank loads the
    same libraries (the counterpart of the JAX trainer's compilation
    cache); a failed build raises on every rank. Alone: `build(names)`."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        build(names)
        return
    error = None
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        try:
            build(names)
        except RuntimeError as exc:
            error = exc
    dist.barrier()
    if error is not None:
        raise error
    missing = [name for name in names if _stale(name)]
    if missing:
        raise RuntimeError(f"local rank 0 did not build {missing}")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib
