"""The token layout and the greedy rules of the cells' decoding options,
worked out from the published tokenizer's layout (openai/whisper
`tokenizer.py`), not taken from the program.

The checkout holds no vocabulary file, so the program runs on its
byte-level vocabulary: ids 0..255 are the bytes, ids 256..eot-1 fillers
that no text produces. Over it openai's non-speech set keeps only the
symbols that encode as one token, the ASCII ones, and the blank set
(" ") is empty, so the first sampled position suppresses EOT alone."""

from __future__ import annotations

from typing import Dict, List

import torch

# openai/whisper tokenizer.py LANGUAGES, in token order (large-v3 adds yue)
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl", "ar", "sv",
    "it", "id", "hi", "fi", "vi", "iw", "uk", "el", "ms", "cs", "ro", "da", "hu", "ta", "no",
    "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr",
    "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu",
    "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl",
    "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su", "yue",
)
NON_SPEECH_ASCII = '"#()*+/:;<=>@[\\]^_`{|}~'
FILLER = b"\x00\xffFILLER"


def special(d: Dict[str, int]) -> Dict[str, int]:
    """Ids of the multilingual layout: 50,257 byte-pair ranks, then EOT,
    SOT, the languages, translate, transcribe, sot_lm, sot_prev,
    no_speech, no_timestamps and the timestamps."""
    eot = 50257
    lang0 = eot + 2
    translate = lang0 + d["n_langs"]
    ids = {"eot": eot, "sot": eot + 1, "lang0": lang0, "translate": translate,
           "transcribe": translate + 1, "no_timestamps": translate + 5,
           "timestamp_begin": translate + 6}
    if ids["timestamp_begin"] + 1501 != d["n_vocab"]:
        raise ValueError(f"vocab {d['n_vocab']} does not hold the multilingual "
                         f"layout with {d['n_langs']} languages")
    return ids


def prompt(d: Dict[str, int], language: str = "en") -> List[int]:
    """<|startoftranscript|><|en|><|transcribe|><|notimestamps|>."""
    ids = special(d)
    if language != "en":
        raise ValueError("the cells transcribe English: language='en'")
    return [ids["sot"], ids["lang0"], ids["transcribe"], ids["no_timestamps"]]


def allowed(d: Dict[str, int], device, first: bool) -> torch.Tensor:
    """(vocab,) True where a greedy step without timestamps and with
    suppress_tokens='-1' may choose: the text ids and EOT, less the
    non-speech symbols; EOT not at the first sampled position."""
    eot = special(d)["eot"]
    mask = torch.zeros(d["n_vocab"], dtype=torch.bool, device=device)
    mask[:eot + 1] = True
    mask[torch.tensor([ord(c) for c in NON_SPEECH_ASCII], device=device)] = False
    if first:
        mask[eot] = False
    return mask


def text(tokens: List[int]) -> str:
    """A window's segment text: its text tokens decoded over the byte-level
    vocabulary; whitespace alone gives an empty segment (openai clears
    it)."""
    raw = b"".join(bytes([t]) if t < 256 else FILLER + str(t).encode()
                   for t in tokens if t < 50257)
    s = raw.decode("utf-8", errors="replace")
    return s if s.strip() else ""
