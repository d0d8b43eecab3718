"""A whole run of each cell on the CPU at a tiny size (the chip check
skipped) with the timed path broken underneath: `correct` must come out
false. One run for each fault the cell can have: a decode step that leaves
its cache unchanged; half of the batch left out, the rest copied or
averaged in; a token or an answer altered where it is produced. (No cell
takes more than one chip, so none has an exchange between chips to leave
out.) Every answer is teacher-forced here, so that each fault meets the
comparison in one run; a run on the card draws its sample from the seed.

The gaps are held to a limit set at this size by the cells' rule: the
program here computes in float32 and reads under 1e-5, the 4-bit control
above 1e-2 (`test_control_reads_wider_than_the_program_on_cpu`), so the
limit is 1e-3. The cells' own limits were set from readings at their own
sizes on the card, where the program computes in bfloat16.

The control, the reference at 4 bits in the program's place, is kept
here too: at the cells' own sizes on the card (`cuda`), and at the tiny
size on the CPU, where it must read wider than the program."""

from __future__ import annotations

import copy
import json

import pytest
import torch

import openai_whisper_coreml_tpu_torch.decoding as decoding
import openai_whisper_coreml_tpu_torch.models.decoder as dec_mod
import openai_whisper_coreml_tpu_torch.serve as serve
from portbench import run
from portbench.lib import spec
from portbench.tests.conftest import TINY, WIDE, tiny_cell

TRANSCRIPTION = ("turbo-batch-long", "turbo-online-short")
DECODE = ("v3-decode-b128",)
TINY_LIMIT = 1e-3


def _gap(name):
    limits = spec.cell_file(name)["check"]["limits"]
    return "served_gap" if "served_gap" in limits else "lang_gap"


def _run(name, limit=TINY_LIMIT, config=WIDE):
    cell = tiny_cell(name)
    cell["check"]["others"] = 1000  # every answer
    cell["check"]["windows"] = 1000
    cell["check"]["limits"][_gap(name)] = limit
    return run.run_cell(name, 2**32 + 11, 0.5, False, torch.device("cpu"), spec.benchmark(),
                        cell=cell, config=copy.deepcopy(config), t_start=0.0)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(dec_mod, "_cache_write", lambda buf, l, val, where: None)


def _half_batch(monkeypatch):
    original = serve._decode_windows_static

    def half(model, windows, options):
        h = max(1, len(windows) // 2)
        original(model, windows[:h], options)
        for i, w in enumerate(windows[h:]):
            w.result = windows[i % h].result

    monkeypatch.setattr(serve, "_decode_windows_static", half)


def _token_altered(monkeypatch):
    original = decoding.sample_tokens

    def altered(logits, temperature, seed, pos, row0=0):
        tok = original(logits, temperature, seed, pos, row0)
        if pos == 6:
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % 256
        return tok

    monkeypatch.setattr(decoding, "sample_tokens", altered)


def _half_decode(monkeypatch):
    original = decoding.decode

    def half(model, mel, options=decoding.DecodingOptions(), **kw):
        h = max(1, mel.shape[0] // 2)
        results = original(model, mel[:h], options, **kw)
        return results + [results[i % h] for i in range(mel.shape[0] - h)]

    monkeypatch.setattr(decoding, "decode", half)


def _answer_altered(monkeypatch):
    original = decoding._detect_language_core

    def altered(decoder, feats):
        idx, probs = original(decoder, feats)
        return idx, probs.roll(1, dims=-1)

    monkeypatch.setattr(decoding, "_detect_language_core", altered)


def _half_languages(monkeypatch):
    original = decoding._detect_language_core

    def half(decoder, feats):
        h = max(1, feats.shape[0] // 2)
        idx, probs = original(decoder, feats[:h])
        rest = probs.mean(dim=0, keepdim=True).expand(feats.shape[0] - h, -1)
        probs = torch.cat([probs, rest])
        return probs.argmax(dim=-1), probs

    monkeypatch.setattr(decoding, "_detect_language_core", half)


@pytest.mark.parametrize("name", TRANSCRIPTION)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_transcription_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", DECODE)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_decode, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_decode_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    # at d_model 128 every window decodes the same tokens, so a window's
    # answer copied to another is that window's right answer; at 64 they
    # differ
    result = _run(name, config=TINY if fault is _half_decode else WIDE)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", DECODE)
def test_altered_token_reads_above_the_cells_own_limit(name, monkeypatch):
    """A token altered where it is produced reads a `served_gap` above the
    cell's own limit, not only above this size's."""
    limit = spec.cell_file(name)["check"]["limits"]["served_gap"]
    _token_altered(monkeypatch)
    result = _run(name, limit=limit)
    assert result["checks"]["served_gap"]["value"] > limit
    assert not result["correct"]


@pytest.mark.parametrize("fault", [_answer_altered, _half_languages],
                         ids=["answer_altered", "half_batch"])
def test_language_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _run("v3-langid")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", TRANSCRIPTION + ("v3-langid",) + DECODE)
def test_control_reads_wider_than_the_program_on_cpu(name):
    """The tiny cell's run, judged also with the 4-bit control: its gap is
    the wider (the program on the CPU computes in float32)."""
    ctx, out, _, _ = run.serve_cell(name, 2**32 + 13, 0.5, False, torch.device("cpu"),
                                    cell=tiny_cell(name), config=copy.deepcopy(WIDE),
                                    t_start=0.0)
    checks = run.judge_outcome(ctx, out, torch.float32, control=True)
    assert checks[_gap(name)]["value"] < 1e-5
    assert checks["control_gap"]["value"] > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_control_fails_the_limit_on_the_card(name, capsys):
    """At the cell's own size on the card, on three seeds: the control's
    gap is above the cell's limit on every seed (a short window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the card")
    from portbench import calibrate

    seeds = "2147483659,2147483677,2147483693"
    assert calibrate.main(["--workload", name, "--seconds", "5", "--seeds", seeds,
                           "--control-seeds", seeds]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"seed"')]
    limit = spec.cell_file(name)["check"]["limits"][_gap(name)]
    assert len(rows) == 3 and all(r["control_gap"] > limit for r in rows)
