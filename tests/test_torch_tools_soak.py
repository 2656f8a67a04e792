"""tools/soak.py against the JAX package's scripts/soak.py (loaded by path;
it imports no JAX at module level): `stage_corpus` writes the script's
bytes, with one worker process at a time and with two; the summary folds the script's
own epoch rows and log into the JAX evidence's numbers with the JAX
summary's keys; and the soak runs the trainer CLI on the CPU (tiny-cls,
--max-steps, then a resume) with no signal. The soak's SIGTERM path runs on the card (chip_smoke.py phase
14); the trainer's own SIGTERM path is tested in test_torch_trainer.py."""

import hashlib
import importlib.util
import json
import pathlib

import pytest
import torch

from calm_vit_dte_tpu_torch.tools import soak

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EVIDENCE = ROOT / "docs" / "evidence"
# The port's own keys beside the JAX summary's (the card, the SIGTERM step,
# the kernels launched, the resumed segment).
PORT_SOAK_KEYS = {"card", "sigterm_sent", "sigterm_step", "kernel_launches",
                  "resume"}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("workers", [1, 2])
def test_stage_corpus_writes_the_jax_scripts_bytes(tmp_path, monkeypatch,
                                                   split, workers):
    _script("soak").stage_corpus(tmp_path / "jax", 2, 3, 64, split=split)
    monkeypatch.setattr(soak, "STAGE_WORKERS", workers)
    soak.stage_corpus(tmp_path / "port", 2, 3, 64, split=split)
    jax, port = _digest(tmp_path / "jax"), _digest(tmp_path / "port")
    assert len(jax) == 7   # 2 x 3 JPEGs and the marker
    assert port == jax


def test_stage_corpus_skips_a_staged_split(tmp_path, capsys):
    soak.stage_corpus(tmp_path, 1, 2, 32)
    before = _digest(tmp_path)
    soak.stage_corpus(tmp_path, 1, 2, 32)
    assert "already staged" in capsys.readouterr().out
    assert _digest(tmp_path) == before


def test_fold_of_the_jax_soaks_rows_is_the_jax_summary():
    """The port's fold of scripts/soak.py's own epoch rows and log gives the
    JAX evidence's summary, key for key (read only)."""
    want = json.loads((EVIDENCE / "soak.json").read_text())
    rows = [json.loads(line) for line in
            (EVIDENCE / "soak_epochs.jsonl").read_text().splitlines()]
    log = (EVIDENCE / "soak_train.log").read_text()
    got = soak.fold(rows, log, want["checkpoints_kept"], want["rc"],
                    want["wall_s"], want["config"])
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}


@pytest.mark.parametrize("rows", [0, 1, 3])
def test_fold_of_given_rows(rows):
    given = [{"epoch": e, "steps": 4, "wall_s": 2.0,
              "p50_step_s": 0.5 - 0.1 * e if e else None,
              "steps_per_s": 2.0, "img_per_s": 64.0 + e,
              "rss_mb": 1000.0 + 10 * e, "loss": 7.0 - e}
             for e in range(rows)]
    log = ("resumed from step 4\n" * 2
           + "SIGTERM: checkpointed at step 9; exiting\n")
    got = soak.fold(given, log, [4, 8, 9, 12], 0, 1.0, {})
    assert got["epochs_completed"] == rows
    assert got["steps_total"] == 4 * rows
    assert got["resumed_segments"] == 2 and got["sigterm_checkpointed"]
    assert got["checkpoints_kept"] == [4, 8, 9, 12]
    assert not got["max_to_keep_respected"]
    if rows:
        assert got["p50_first_epoch_s"] is None
        assert got["p50_all"] == sorted(0.5 - 0.1 * e
                                        for e in range(1, rows))
        assert got["rss_mb_last"] == 1000.0 + 10 * (rows - 1)
        assert got["loss_first"] == 7.0
    else:
        assert got["p50_all"] == [] and got["loss_last"] is None


def test_checkpoint_steps_reads_the_trainers_files(tmp_path):
    for name in ("step_3.pt", "step_12.pt", "step_7.pt", "step_7.pt.1.tmp",
                 "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "5").mkdir()   # an Orbax step directory is not the port's
    assert soak.checkpoint_steps(tmp_path) == [3, 7, 12]
    assert soak.checkpoint_steps(tmp_path / "absent") == []


def test_soak_runs_the_trainer_cli_and_resumes(tmp_path, monkeypatch):
    """The soak on the CPU at tiny-cls: a corpus of 2 classes x 8 JPEGs, the
    trainer CLI for --max-steps 3 (an epoch of 2 steps at B=8, then one
    more), no signal, then a one-step resume from its checkpoint; the
    summary has the JAX summary's keys and the port's own."""
    # The trainer processes: one thread each, SIGTERM after 3 minutes.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    summary = soak.main([
        "--device", "cpu", "--config", "tiny-cls", "--classes", "2",
        "--per-class", "8", "--img-size", "64", "--batch", "8",
        "--microbatch", "1", "--minutes", "3", "--max-steps", "3",
        "--resume-steps", "1", "--log-every", "1",
        "--corpus", str(tmp_path / "corpus"), "--ckpt-dir",
        str(tmp_path / "ckpt"), "--out", str(tmp_path / "out")])
    want = set(json.loads((EVIDENCE / "soak.json").read_text()))
    assert set(summary) - PORT_SOAK_KEYS == want
    assert summary["rc"] == 0 and not summary["sigterm_sent"]
    assert summary["epochs_completed"] == 2      # one whole, one cut short
    assert summary["steps_total"] == 3
    assert summary["checkpoints_kept"] == [2, 3]
    assert summary["resumed_segments"] == 1
    resume = summary["resume"]
    assert resume["rc"] == 0 and resume["resumed_from_step"] == 3
    assert resume["checkpoints_kept"] == [2, 3, 4]
    assert summary["max_to_keep_respected"]
    assert summary["card"] == {"name": None, "nvidia_smi": None}
    assert summary["kernel_launches"] == {}      # plain versions on the CPU
    written = json.loads((tmp_path / "out" / "soak.json").read_text())
    assert written == json.loads(json.dumps(summary))
    assert {p.name for p in (tmp_path / "out").iterdir()} == {
        "soak.json", "soak_epochs.jsonl", "soak_train.log"}
