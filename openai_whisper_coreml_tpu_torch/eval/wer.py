"""Word-error-rate metrics + text normalisation (port of `eval/wer.py`).

A copy of the JAX package's module (which the port cannot import: its
package imports jax). Levenshtein alignment over words plus the
openai-faithful EnglishTextNormalizer (eval/normalizers.py: contraction
and abbreviation expansion, number standardisation, British->American
spellings), so a measured WER is comparable to published Whisper numbers.
Host-side numpy; no device work.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .normalizers import BasicTextNormalizer, EnglishTextNormalizer


@functools.lru_cache(maxsize=2)
def _normalizer(language: Optional[str]):
    if language in (None, "en"):
        return EnglishTextNormalizer()
    return BasicTextNormalizer()


def normalize_text(text: str, language: Optional[str] = "en") -> str:
    """Normalise a transcript for WER comparison (openai semantics)."""
    return _normalizer(language)(text)


@dataclass
class WERResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    hits: int
    n_ref_words: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "wer": self.wer,
            "substitutions": self.substitutions,
            "deletions": self.deletions,
            "insertions": self.insertions,
            "hits": self.hits,
            "ref_words": self.n_ref_words,
        }


def word_errors(ref_words: Sequence[str], hyp_words: Sequence[str]
                ) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) via Levenshtein DP.

    Vectorised anti-diagonal sweep (cells on one anti-diagonal only depend
    on the two previous diagonals) + an O(n+m) backtrace for the error
    breakdown — the O(n*m) Python inner loop was the eval bottleneck at
    LibriSpeech scale (2,620 utterance pairs)."""
    import numpy as np

    n, m = len(ref_words), len(hyp_words)
    if n == 0:
        return 0, 0, m, 0
    if m == 0:
        return 0, n, 0, 0

    ids: Dict[str, int] = {}
    r = np.fromiter((ids.setdefault(w, len(ids)) for w in ref_words),
                    np.int32, n)
    h = np.fromiter((ids.setdefault(w, len(ids)) for w in hyp_words),
                    np.int32, m)
    sub_cost = (r[:, None] != h[None, :]).astype(np.int32)  # (n, m)

    d = np.zeros((n + 1, m + 1), np.int32)
    d[0, :] = np.arange(m + 1)
    d[:, 0] = np.arange(n + 1)
    for k in range(2, n + m + 1):
        i = np.arange(max(1, k - m), min(n, k - 1) + 1)
        if i.size == 0:
            continue
        j = k - i
        diag = d[i - 1, j - 1] + sub_cost[i - 1, j - 1]
        step = np.minimum(d[i - 1, j], d[i, j - 1]) + 1
        d[i, j] = np.minimum(diag, step)

    i, j = n, m
    subs = dels = ins = hits = 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and d[i, j] == d[i - 1, j - 1] + sub_cost[i - 1, j - 1]):
            if sub_cost[i - 1, j - 1]:
                subs += 1
            else:
                hits += 1
            i -= 1
            j -= 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins, hits


def _accumulate_errors(references, hypotheses, tokenize, normalize,
                       language) -> WERResult:
    if len(references) != len(hypotheses):
        raise ValueError("reference/hypothesis count mismatch")
    total_s = total_d = total_i = total_h = total_n = 0
    for ref, hyp in zip(references, hypotheses):
        if normalize:
            ref = normalize_text(ref, language)
            hyp = normalize_text(hyp, language)
        ru, hu = tokenize(ref), tokenize(hyp)
        s, d, i, h = word_errors(ru, hu)
        total_s += s
        total_d += d
        total_i += i
        total_h += h
        total_n += len(ru)
    rate = (total_s + total_d + total_i) / max(total_n, 1)
    return WERResult(rate, total_s, total_d, total_i, total_h, total_n)


def compute_wer(references: Sequence[str], hypotheses: Sequence[str],
                *, normalize: bool = True,
                language: Optional[str] = "en") -> WERResult:
    """language selects the normaliser: the English pipeline (contractions,
    numbers, respellings) only applies to 'en'/None; other languages use
    BasicTextNormalizer — scoring French through English number rules would
    corrupt the WER."""
    return _accumulate_errors(references, hypotheses, str.split,
                              normalize, language)


def compute_cer(references: Sequence[str], hypotheses: Sequence[str],
                *, normalize: bool = True,
                language: Optional[str] = None) -> WERResult:
    """Character error rate — the reporting convention for space-less
    scripts (zh/ja/th/...), where word segmentation is ill-defined and WER
    would score tokenizer luck. Characters are compared after normalisation
    with whitespace removed (the openai/whisper paper convention for
    zh/ja). language=None uses the BASIC normaliser (this metric targets
    non-English text; English number/contraction rules would corrupt it)."""
    return _accumulate_errors(
        references, hypotheses, lambda t: list("".join(t.split())),
        normalize, language if language is not None else "und")
