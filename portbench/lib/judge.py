"""The comparison that decides `correct`: what the timed path served,
judged by the plain reference (`reference/`), after the window.

Transcription (a piece of a recording, or a clip, with its result dict;
its audio, or a function that makes it, and its length `n` in samples):
every answer is checked for its windows (one segment per 30 s window, at
seeks 0, 3000, ...: the missing ones are counted) and for its text (the
concatenation of its segments' tokens decoded over the byte-level
vocabulary: the answers whose text differs are counted). A sample drawn
from the seed, the longest answer's first and last windows among them, is
teacher-forced through the reference over its prompt and served tokens;
`served_gap` is the widest gap by which a served token's reference logit
lies below the reference's best allowed one (EOT included where the
program stopped before `sample_len`). Language ID: each sampled window's
reference log-probabilities over the languages against the program's;
`lang_gap` is the largest absolute difference.

The control (`reference.Reference(weight_bits=4)`) is read on the same
prompts and tokens: at each position the token it puts first, and the
reference's gap for that token."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import model as refm
from portbench.reference import tokens as reft


def _len(a: dict) -> int:
    return a["n"] if "n" in a else len(a["audio"])


def _audio(a: dict):
    return a["audio"]() if callable(a["audio"]) else a["audio"]


def picks(answers: List[dict], seed: int, n_others: int) -> List[Tuple[int, int]]:
    """(answer, window) pairs to teacher-force: the longest answer's first
    and last windows, and one window of each of `n_others` other answers,
    drawn from the seed. Only answers that came are drawn."""
    came = [i for i, a in enumerate(answers) if a.get("result") is not None]
    if not came:
        return []
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    longest = max(came, key=lambda i: _len(answers[i]))
    n_win = n_windows(_len(answers[longest]))
    out = [(longest, 0)] + ([(longest, n_win - 1)] if n_win > 1 else [])
    others = [i for i in came if i != longest]
    for i in rng.permutation(others)[:n_others]:
        out.append((int(i), int(rng.integers(n_windows(_len(answers[int(i)]))))))
    return out


def n_windows(n_samples: int) -> int:
    frames = -(-n_samples // refm.HOP_LENGTH)
    return max(1, -(-frames // refm.N_FRAMES))


def answer_checks(answers: List[dict]) -> Dict[str, int]:
    """Missing windows and texts that differ from their segments' tokens,
    over every answer."""
    missing = mismatch = 0
    for a in answers:
        want = n_windows(_len(a))
        res = a.get("result")
        if res is None:
            missing += want
            continue
        seeks = [s.get("seek") for s in res.get("segments", [])]
        missing += sum(1 for w in range(want) if w * refm.N_FRAMES not in seeks)
        missing += max(0, len(seeks) - want)
        text = "".join(reft.text(s.get("tokens", [])) for s in res.get("segments", []))
        mismatch += text != res.get("text")
    return {"missing": missing, "text_mismatch": mismatch}


def _served(a: dict, w: int) -> Optional[List[int]]:
    for s in a["result"].get("segments", []):
        if s.get("seek") == w * refm.N_FRAMES:
            return [int(t) for t in s.get("tokens", [])]
    return None


def _gaps(logits: torch.Tensor, chosen: torch.Tensor, d: dict) -> torch.Tensor:
    """Per position: the best allowed reference logit less the chosen
    token's; +inf where the chosen token is not allowed there."""
    allowed = reft.allowed(d, logits.device, first=False).expand(len(chosen), -1).clone()
    allowed[0] = reft.allowed(d, logits.device, first=True)
    best = logits.masked_fill(~allowed, -math.inf).amax(dim=-1)
    got = logits.gather(1, chosen[:, None])[:, 0]
    legal = allowed.gather(1, chosen[:, None])[:, 0]
    return torch.where(legal, best - got, torch.full_like(best, math.inf))


def transcript_gaps(ref: refm.Reference, d: dict, answers: List[dict],
                    chosen: List[Tuple[int, int]], sample_len: int, device,
                    control: Optional[refm.Reference] = None) -> Dict[str, float]:
    """`served_gap` over the chosen windows (and `control_gap`, the gap of
    the control's first choices, with a control), and the tokens read."""
    prompt = reft.prompt(d)
    eot = reft.special(d)["eot"]
    worst = {"served_gap": 0.0, "tokens": 0}
    if control is not None:
        worst["control_gap"] = 0.0
    by_answer: Dict[int, List[int]] = {}
    for i, w in chosen:
        by_answer.setdefault(i, []).append(w)
    for i, wins in by_answer.items():
        audio = torch.as_tensor(_audio(answers[i]), device=device)
        mel, content = refm.recording_mel(audio, d["n_mels"])
        for w in wins:
            served = _served(answers[i], w)
            if not served:
                continue
            decisions = served + ([eot] if len(served) < sample_len else [])
            wmel = refm.window_mel(mel, w * refm.N_FRAMES, content)
            logits = refm.window_logits(ref, wmel, prompt, served)[:len(decisions)]
            gaps = _gaps(logits, torch.tensor(decisions, device=device), d)
            worst["served_gap"] = max(worst["served_gap"], float(gaps.max()))
            worst["tokens"] += len(decisions)
            if control is not None:
                c = refm.window_logits(control, wmel, prompt, served)[:len(decisions)]
                allowed = reft.allowed(d, device, first=False).expand(len(decisions), -1).clone()
                allowed[0] = reft.allowed(d, device, first=True)
                pick = c.masked_fill(~allowed, -math.inf).argmax(dim=-1)
                worst["control_gap"] = max(worst["control_gap"],
                                           float(_gaps(logits, pick, d).max()))
    return worst


def language_gaps(ref: refm.Reference, d: dict, windows: List[dict], device,
                  control: Optional[refm.Reference] = None) -> Dict[str, float]:
    """`lang_gap` (and `control_gap`) over windows {"audio", "probs"}; a
    window without probabilities is missing."""
    ids = reft.special(d)
    codes = reft.LANGUAGES[:d["n_langs"]]
    out = {"lang_gap": 0.0, "missing": 0}
    if control is not None:
        out["control_gap"] = 0.0
    for win in windows:
        if win.get("probs") is None:
            out["missing"] += 1
            continue
        mel = refm.log_mel(torch.as_tensor(win["audio"], device=device), d["n_mels"])[None]
        want = ref.language_logprobs(mel, ids["sot"], ids["lang0"])[0]
        got = torch.tensor([math.log(max(win["probs"][c], 1e-30)) for c in codes],
                           device=device)
        out["lang_gap"] = max(out["lang_gap"], float((got - want).abs().max()))
        if control is not None:
            c = control.language_logprobs(mel, ids["sot"], ids["lang0"])[0]
            out["control_gap"] = max(out["control_gap"], float((c - want).abs().max()))
    return out
