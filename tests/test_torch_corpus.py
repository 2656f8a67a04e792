"""The port's generated corpus (data/corpus.py) writes the same files, byte
for byte, as the JAX package's, in both modes."""

import pytest

from calm_vit_dte_tpu.data.corpus import make_corpus as jax_make_corpus
from calm_vit_dte_tpu_torch.data.corpus import make_corpus


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mode,seed", [("memorize", 11), ("learnable", 12)])
def test_corpus_is_byte_identical_to_jax(tmp_path, mode, seed):
    kw = dict(n_train=6, n_val=2, num_classes=4, size=64, mode=mode,
              seed=seed)
    ours = make_corpus(tmp_path / "port", **kw)
    ref = jax_make_corpus(tmp_path / "jax", **kw)
    got, want = _files(ours), _files(ref)
    assert sum(k.endswith(".jpg") for k in want) == 8
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    # A second call with the same arguments finds the stamp and writes
    # nothing.
    stamp = (ours / ".corpus.txt").stat().st_mtime_ns
    make_corpus(ours, **kw)
    assert (ours / ".corpus.txt").stat().st_mtime_ns == stamp


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        make_corpus(tmp_path, n_train=1, size=8, mode="other")
