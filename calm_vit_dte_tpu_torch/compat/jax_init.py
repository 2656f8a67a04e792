"""The JAX package's initial weights, rebuilt without jax.

calm_vit_dte_tpu/nn/init.py draws every random leaf on the host with numpy:
`default_rng` seeded from the leaf's JAX key data (two uint32), U(-b, b)
for weights and biases (`kaiming_uniform`, `bias_uniform`), a unit-norm
Gaussian for the spectral-norm u and v (`normalized_normal`), in float64,
then cast to float32. So the key data of each leaf is all it takes to draw
the same weights again.

A table holds them, for one config and seed: for every entry of the port's
state_dict its name, shape, how it is made (`uniform` with its bound,
`normalized_normal` with its eps, the draw's key data; or `ones`, `zeros`,
or `values`, the float32 values themselves, kept once per distinct leaf in
the table's `values`: the RoPE frequencies, which XLA's float32 power
computes with other roundings than numpy's or torch's) and a digest of the
JAX leaf's float32 bytes. `tests/_jax_init_table.py` writes it by running the
JAX package's own `vit_init`; the table records the jax version and the
`jax_threefry_partitionable` value it ran under, since the key data follow
both.

`state_dict_from_jax_init(path)` redraws every entry with numpy alone and
checks each digest: a numpy whose `Generator` stream differs from the one
that wrote the table (NEP 19 does not promise the stream across versions)
raises instead of giving other weights. The state_dict loads into the
port's `ViT` with `load_state_dict`, or goes to a reference-format `.pth`
(`torch.save`), which `create_vit(weights=)`, `Predictor.from_checkpoint`
and the trainer's warm start take.

Committed: `jax_init/imagenet-reg-224_seed0.json.gz`.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pathlib

import numpy as np
import torch

TABLES = pathlib.Path(__file__).with_name("jax_init")
FORMAT = 1


def table_path(config: str, seed: int) -> pathlib.Path:
    """Where the committed table of `config` at `seed` lives."""
    return TABLES / f"{config}_seed{seed}.json.gz"


def digest(arr: np.ndarray) -> str:
    """The first 16 hex digits of the sha256 of the float32 bytes (little
    endian, C order)."""
    data = np.ascontiguousarray(arr, dtype="<f4").tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def key_rng(key) -> np.random.Generator:
    """The generator `calm_vit_dte_tpu/nn/init.py::_np_rng` makes from a
    key whose data are the two uint32 `key`."""
    data = np.asarray(key, dtype="<u4").ravel()
    return np.random.default_rng(int.from_bytes(data.tobytes(), "little"))


def draw(entry: dict, values: dict | None = None) -> np.ndarray:
    """One table entry's float32 values; `values` is the table's `values`
    (digest -> list of floats) for a `values` entry."""
    shape = tuple(entry["shape"])
    kind = entry["init"]
    if kind == "uniform":
        b = entry["bound"]
        arr = key_rng(entry["key"]).uniform(-b, b, shape)
    elif kind == "normalized_normal":
        v = key_rng(entry["key"]).standard_normal(shape)
        arr = v / (np.linalg.norm(v) + entry["eps"])
    elif kind == "ones":
        arr = np.ones(shape)
    elif kind == "zeros":
        arr = np.zeros(shape)
    elif kind == "values":
        arr = np.reshape(values[entry["sha"]], shape)
    else:
        raise ValueError(f"{entry['name']}: unknown init {kind!r}")
    return np.asarray(arr, dtype=np.float32)


def load_table(path: str | pathlib.Path) -> dict:
    with gzip.open(path, "rt") as f:
        table = json.load(f)
    if table.get("format") != FORMAT:
        raise ValueError(f"{path}: table format {table.get('format')!r}, "
                         f"this module reads {FORMAT}")
    return table


def write_table(table: dict, path: str | pathlib.Path) -> None:
    """Write `table` as gzipped JSON, one leaf a line, with no timestamp in
    the gzip header, so the same table gives the same bytes."""
    leaves = ",\n".join(json.dumps(e, sort_keys=True)
                        for e in table["leaves"])
    head = json.dumps({k: v for k, v in table.items() if k != "leaves"},
                      sort_keys=True)
    text = head[:-1] + ', "leaves": [\n' + leaves + "\n]}\n"
    with open(path, "wb") as raw, gzip.GzipFile(
            fileobj=raw, mode="wb", filename="", mtime=0) as f:
        f.write(text.encode())


def state_dict_from_jax_init(path: str | pathlib.Path
                             ) -> dict[str, torch.Tensor]:
    """The port's fp32 state_dict of the JAX package's initial weights the
    table at `path` describes. Raises ValueError on the first entry whose
    redraw misses its digest."""
    table = load_table(path)
    sd = {}
    for entry in table["leaves"]:
        arr = draw(entry, table.get("values"))
        got = digest(arr)
        if got != entry["sha"]:
            raise ValueError(
                f"{entry['name']}: redrawn digest {got} != the table's "
                f"{entry['sha']} (numpy {np.__version__}; the table was "
                f"written with numpy {table.get('numpy_version')}, jax "
                f"{table.get('jax_version')})")
        sd[entry["name"]] = torch.from_numpy(arr)
    return sd
