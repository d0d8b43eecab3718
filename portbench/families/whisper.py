"""The Whisper family: the port's `WhisperModel` of a configuration file
under the model card's names, its seeded weights (`lib/weights.py`), and
the judge over the plain Whisper (`reference/model.py`, `lib/judge.py`).

Three kinds of answer are judged. "transcripts" (recordings through
`serve.transcribe_batch` or the HTTP server): missing windows, texts that
differ from their segments' tokens, and `served_gap` over a sample drawn
from the seed (`judge.transcript_gaps`). "languages": `lang_gap` over the
sampled windows' language log-probabilities. "windows" (30 s windows
through `decoding.decode`, each {"audio", "tokens"}; "tokens" None where
no result came): missing windows, and `served_gap` over `check.windows`
windows drawn from the seed, the one with the most served tokens among
them, teacher-forced over the log-mel of the window as the program was
handed it."""

from __future__ import annotations

import math
from typing import Dict, List

from portbench.lib.weights import make_params  # the family's seeded weights


def dims(config: dict) -> Dict[str, int]:
    """The sizes of a configuration file, under the port's names."""
    return {
        "n_mels": config["num_mel_bins"],
        "n_vocab": config["vocab_size"],
        "n_audio_ctx": config["max_source_positions"],
        "n_audio_state": config["d_model"],
        "n_audio_head": config["encoder_attention_heads"],
        "n_audio_layer": config["encoder_layers"],
        "n_text_ctx": config["max_target_positions"],
        "n_text_state": config["d_model"],
        "n_text_head": config["decoder_attention_heads"],
        "n_text_layer": config["decoder_layers"],
        "n_ffn": config["encoder_ffn_dim"],
        "n_langs": config["n_languages"],
    }


def program_config(config: dict, d: Dict[str, int]):
    from openai_whisper_coreml_tpu_torch.config import WhisperConfig

    if d["n_ffn"] != 4 * d["n_audio_state"]:
        raise ValueError("the port's MLP is 4 x d_model wide")
    return WhisperConfig(
        name=config["name"], n_mels=d["n_mels"], n_vocab=d["n_vocab"],
        n_audio_ctx=d["n_audio_ctx"], n_audio_state=d["n_audio_state"],
        n_audio_head=d["n_audio_head"], n_audio_layer=d["n_audio_layer"],
        n_text_ctx=d["n_text_ctx"], n_text_state=d["n_text_state"],
        n_text_head=d["n_text_head"], n_text_layer=d["n_text_layer"],
        n_langs=d["n_langs"], multilingual=True)


def program(config: dict, d: Dict[str, int], params: dict):
    """The port's model of those weights, quantized by the port as the
    configuration's `dtypes.weights` says."""
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params

    return model_from_params(program_config(config, d), params,
                             quantize=config["dtypes"]["weights"])


def window_picks(answers: List[dict], seed: int, n: int) -> List[int]:
    """`n` windows that came, drawn from the seed, the one with the most
    served tokens among them first."""
    from portbench.lib.cell import rng

    came = [i for i, a in enumerate(answers) if a["tokens"] is not None]
    drawn = [came[int(j)] for j in rng(seed, 7).permutation(len(came))[:n]]
    return sorted(drawn, key=lambda i: -len(answers[i]["tokens"]))


def window_gaps(ref, d: Dict[str, int], answers: List[dict], chosen: List[int],
                sample_len: int, device, control=None) -> Dict[str, float]:
    """`served_gap` over the chosen windows (and `control_gap` with a
    control), as `judge.transcript_gaps` reads it, each window's log-mel
    made from its own 30 s of audio."""
    import torch

    from portbench.lib import judge
    from portbench.reference import model as refm
    from portbench.reference import tokens as reft

    prompt = reft.prompt(d)
    eot = reft.special(d)["eot"]
    worst = {"served_gap": 0.0, "tokens": 0}
    if control is not None:
        worst["control_gap"] = 0.0
    for i in chosen:
        served = [int(t) for t in answers[i]["tokens"]]
        decisions = served + ([eot] if len(served) < sample_len else [])
        mel = refm.log_mel(torch.as_tensor(answers[i]["audio"], device=device), d["n_mels"])
        logits = refm.window_logits(ref, mel, prompt, served)[:len(decisions)]
        gaps = judge._gaps(logits, torch.tensor(decisions, device=device), d)
        worst["served_gap"] = max(worst["served_gap"], float(gaps.max()))
        worst["tokens"] += len(decisions)
        if control is not None:
            c = refm.window_logits(control, mel, prompt, served)[:len(decisions)]
            allowed = reft.allowed(d, device, first=False).expand(len(decisions), -1).clone()
            allowed[0] = reft.allowed(d, device, first=True)
            pick = c.masked_fill(~allowed, -math.inf).argmax(dim=-1)
            worst["control_gap"] = max(worst["control_gap"],
                                       float(judge._gaps(logits, pick, d).max()))
    return worst


def judge(ctx, out, dtype, control: bool = False) -> dict:
    """The numbers compared, each {"value", "limit"}, after the program is
    freed: the reference is built from the same seeded weights, made
    again. With `control`, also `control_gap` (no limit): the gap of the
    tokens (or the log-probabilities) of the reference at 4 bits."""
    import torch

    from portbench.lib import judge as jd
    from portbench.reference import model as refm

    d, cell = ctx.dims, ctx.cell
    refm.exact_float32()
    params = make_params(d, ctx.seed, ctx.device, dtype)
    ref = refm.Reference(params, d, weight_bits=8)
    ctl = refm.Reference(params, d, weight_bits=4) if control else None
    del params
    with torch.no_grad():
        if out.kind == "transcripts":
            numbers = jd.answer_checks(out.answers)
            chosen = jd.picks(out.answers, ctx.seed, cell["check"]["others"])
            gaps = jd.transcript_gaps(ref, d, out.answers, chosen,
                                      cell["options"]["sample_len"], ctx.device, ctl)
            numbers["served_gap"] = gaps["served_gap"]
            ctx.log(f"teacher-forced {len(chosen)} windows, {gaps['tokens']} served tokens")
        elif out.kind == "windows":
            chosen = window_picks(out.answers, ctx.seed, cell["check"]["windows"])
            gaps = window_gaps(ref, d, out.answers, chosen, cell["options"]["sample_len"],
                               ctx.device, ctl)
            numbers = {"missing": out.failed, "served_gap": gaps["served_gap"]}
            ctx.log(f"teacher-forced {len(chosen)} windows, {gaps['tokens']} served tokens")
        else:
            gaps = jd.language_gaps(ref, d, out.answers, ctx.device, ctl)
            numbers = {"missing": gaps["missing"] + out.failed, "lang_gap": gaps["lang_gap"]}
            ctx.log(f"compared {len(out.answers)} windows' language log-probabilities")
    limits = cell["check"]["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    if control:
        checks["control_gap"] = {"value": gaps["control_gap"], "limit": None}
    return checks

