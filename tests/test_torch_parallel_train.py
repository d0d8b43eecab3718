"""Sharded training in the port (`train.make_train_step(..., mesh=)`,
`finetune --mesh-model`, `cli --tensor-parallel`) against its one-process
step, on gloo ranks spawned on the CPU (`torch_parallel_worker`).

fp32 updates on (2, 1), (1, 2) and (2, 2) meshes: gradient accumulation,
a clip norm small enough to act, the flash path, and a LoRA case on an
int8 base with adapters on column- and row-parallel linears. The batches'
data halves hold unequal token counts, so a loss that averaged per-rank
means would miss. Losses and every gathered leaf equal the one-process
run's within rtol 1e-5 (of the leaf's scale near zero). The fine-tune
tool and the CLI run under spawned ranks too: rank 0 alone writes each
file; the CLI's files are the one-process CLI's, the fine-tune logs the
one-process run's losses and resumes bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch import finetune
from openai_whisper_coreml_tpu_torch.utils import audio_io
from openai_whisper_coreml_tpu_torch.utils.checkpoint import read_safetensors

from . import torch_parallel_worker as worker

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2), (2, 2)]
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def reference():
    return {case: worker.run_training(case) for case in worker.TRAIN_CASES}


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def ranks(request):
    n_data, n_model = request.param
    return worker.spawn(n_data * n_model, worker.train_checks, n_data, n_model)


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_sharded_training_matches_one_process(ranks, reference, case):
    want_losses, want = reference[case]
    losses, tree = ranks[0][case]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert set(tree) == set(want)
    for path, leaf in want.items():
        # rtol 1e-5 of each element, and of the leaf's scale for elements
        # near zero (float noise of 1e-9 is a large part of 1e-5)
        np.testing.assert_allclose(tree[path], leaf, rtol=1e-5,
                                   atol=1e-5 * np.abs(leaf).max(), err_msg=path)
    for other in ranks[1:]:
        o_losses, digest = other[case]
        assert o_losses == losses
        assert digest == {k: float(np.abs(v).sum()) for k, v in tree.items()}


def test_training_issues_no_collective_over_one_rank(ranks):
    """A mesh axis of one rank sums nothing: the data group's gradient and
    loss sums on (1, m), the model group's on (d, 1) are left out."""
    for res in ranks:
        assert res["one_rank_reduces"] == 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_corpus")
    rng = np.random.default_rng(0)
    for i in range(4):
        t = np.arange(16000) / 16000
        x = (0.2 * np.sin(2 * np.pi * (160 + 30 * i) * t)
             + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        audio_io.save_wav(str(root / f"u{i}.wav"), x, 16000)
        (root / f"u{i}.txt").write_text(f"utterance number {i}")
    return str(root)


def _ft_args(corpus, out, *extra):
    return [corpus, "--model", worker.FT_MODEL, "--device", "cpu",
            "--batch-size", "2", "--max-len", "12", "--learning-rate", "1e-3",
            "--output", out, *extra]


def _losses(log: str) -> list:
    return [line.split()[2] for line in log.splitlines() if line.startswith("step ")]


def test_finetune_mesh_model_writes_once_and_resumes(corpus, tmp_path, monkeypatch,
                                                     capsys):
    """`finetune --mesh-model 2` on two ranks: rank 0 alone logs and writes
    the checkpoints and the train state, logging the one-process run's
    losses; a `--resume` of that state on both ranks ends on the weights
    of an uninterrupted mesh run, bit for bit. (The weights themselves are
    held against one process in test_sharded_training_matches_one_process:
    here the default AdamW eps makes near-zero gradients' first updates a
    coin flip of summation noise.)"""
    from openai_whisper_coreml_tpu_torch import config as tconfig
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config

    monkeypatch.setitem(tconfig.CONFIGS, worker.FT_MODEL,
                        tiny_test_config(**worker.FT_SIZE))
    one, mesh, state = (str(tmp_path / n) for n in ("one", "mesh", "state"))
    capsys.readouterr()
    assert finetune.main(_ft_args(corpus, one, "--steps", "2", "--log-every", "1")) == 0
    want_losses = _losses(capsys.readouterr().out)
    tp = ["--mesh-model", "2", "--log-every", "1"]
    ranks = worker.spawn(2, worker.finetune_run, _ft_args(
        corpus, mesh, "--steps", "2", "--save-every", "2", "--save-state", state, *tp))
    assert [w for w, _ in ranks] == [
        [mesh + "-2.safetensors", state, mesh + "-final.safetensors"], []]
    assert _losses(ranks[0][1]) == want_losses and ranks[1][1] == ""
    resumed = worker.spawn(2, worker.finetune_run, _ft_args(
        corpus, mesh + "r", "--steps", "3", "--resume", state, *tp))
    straight = worker.spawn(2, worker.finetune_run, _ft_args(
        corpus, mesh + "s", "--steps", "3", *tp))
    assert [w for w, _ in resumed] == [[mesh + "r-final.safetensors"], []]
    assert [w for w, _ in straight] == [[mesh + "s-final.safetensors"], []]
    got = read_safetensors(mesh + "r-final.safetensors")[0]
    want = read_safetensors(mesh + "s-final.safetensors")[0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_tensor_parallel_writes_once(tmp_path, monkeypatch):
    """`cli --tensor-parallel 2` on two ranks writes each output file once,
    from rank 0, with the one-process CLI's transcript."""
    from openai_whisper_coreml_tpu_torch import cli

    rng = np.random.default_rng(1)
    t = np.arange(int(16000 * 1.5)) / 16000
    wav = str(tmp_path / "clip.wav")
    audio_io.save_wav(wav, (0.2 * np.sin(2 * np.pi * 220 * t)
                            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32),
                      16000)
    args = [wav, "--language", "en", "--output-format", "all",
            "--temperature-increment-on-fallback", "0"]
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model", worker.cli_model)
    assert cli.main(args + ["-o", str(tmp_path / "one")]) == 0
    writes = worker.spawn(2, worker.cli_run, args + [
        "--tensor-parallel", "2", "-o", str(tmp_path / "tp")])
    assert writes == [[("clip.wav", "all")], []]
    for fmt in ("txt", "srt", "vtt", "tsv"):
        assert ((tmp_path / "tp" / f"clip.{fmt}").read_text()
                == (tmp_path / "one" / f"clip.{fmt}").read_text()), fmt
    got, want = (json.loads((tmp_path / d / "clip.json").read_text())
                 for d in ("tp", "one"))
    assert [s["tokens"] for s in got["segments"]] == [
        s["tokens"] for s in want["segments"]]
    assert sorted(os.listdir(tmp_path / "tp")) == sorted(os.listdir(tmp_path / "one"))
