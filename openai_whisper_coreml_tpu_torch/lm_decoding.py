"""Entry points of the audio language model (`models/audio_lm.AudioLM`):
`answer`, one answer's log-probabilities per clip, and `generate`, greedy
generation through a KV cache.

Each clip is one 30 s log-mel window and a prompt (before, after): the
text tokens before the audio and after it, the audio's `audio_tokens`
embeddings between them. A call packs its clips' tokens (`audio_lm.pack`)
and runs them through the encoder, the connector and the decoder once;
the answer is read at each clip's last position, over the whole
vocabulary.

Routes, on request: for each clip an int8 tensor (n_layer, its tokens,
top_k) of the routed experts each token's MoE picked, -1 for a slot left
empty or taken by a null expert (`models/moe.route`)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .models.audio_lm import AudioLM, Layout, Prompt, pack


def _clip_routes(layers: List[torch.Tensor], lay: Layout) -> List[torch.Tensor]:
    """Each layer's (N, top_k) routes as each clip's (n_layer, T_b, top_k)."""
    return list(torch.stack(layers).split(lay.lengths, dim=1))


def answer(model: AudioLM, mel: torch.Tensor, prompts: Sequence[Prompt],
           routes: bool = False):
    """Log-probabilities (B, n_vocab) fp32 of each clip's next token after
    its prompt, for mel (B, n_mels, 3000) and B prompts; with `routes`,
    (log-probabilities, each clip's routes)."""
    if len(prompts) != mel.shape[0]:
        raise ValueError(f"{len(prompts)} prompts for {mel.shape[0]} clips")
    with torch.no_grad():
        lay = pack(prompts, model.cfg.audio_tokens, model.device)
        h, layers = model.prefill(model.audio_embeddings(mel), lay)
        lp = model.logprobs(h.index_select(0, lay.last_rows))
    return (lp, _clip_routes(layers, lay)) if routes else lp


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (B, max_new_tokens) greedy picks
    logprobs: Optional[torch.Tensor] = None  # (max_new_tokens, B, n_vocab) each pick's
    routes: Optional[List[torch.Tensor]] = None  # each clip's (n_layer, T_b + max_new_tokens - 1, top_k)


def generate(model: AudioLM, mel: torch.Tensor, prompts: Sequence[Prompt],
             max_new_tokens: int, *, logprobs: bool = False,
             routes: bool = False) -> Generation:
    """Greedy generation of `max_new_tokens` a clip: the prompt's prefill,
    which writes the cache, then single-token steps over it (bf16 on the
    card), each clip at its own position. With `logprobs`, the
    log-probabilities each pick was made from; with `routes`, each clip's
    routes over its prompt and the generated tokens fed back."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be at least 1")
    with torch.no_grad():
        lay = pack(prompts, model.cfg.audio_tokens, model.device)
        cache = model.new_cache(lay.batch, lay.t_max + max_new_tokens)
        h, pre = model.prefill(model.audio_embeddings(mel), lay, cache)
        lp = model.logprobs(h.index_select(0, lay.last_rows))
        positions = torch.tensor(lay.lengths, device=model.device)
        picks, kept, steps = [], [], []
        for s in range(max_new_tokens):
            tok = lp.argmax(dim=-1)
            picks.append(tok)
            if logprobs:
                kept.append(lp)
            if s == max_new_tokens - 1:
                break
            h, layers = model.step(tok, positions, cache)
            steps.append(torch.stack(layers))
            positions = positions + 1
            lp = model.logprobs(h)
    out = Generation(torch.stack(picks, dim=1))
    if logprobs:
        out.logprobs = torch.stack(kept)
    if routes:
        clips = _clip_routes(pre, lay)
        if steps:
            grown = torch.stack(steps, dim=2)  # (n_layer, B, steps, top_k)
            clips = [torch.cat([c, grown[:, b]], dim=1) for b, c in enumerate(clips)]
        out.routes = clips
    return out
