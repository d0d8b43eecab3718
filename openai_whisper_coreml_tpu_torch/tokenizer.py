"""Whisper tokenizer: byte-level BPE + special-token layout.

A framework-free copy of `openai_whisper_coreml_tpu/tokenizer.py` (that
package imports JAX on import), bound to the port's config. It implements:

  * GPT-2-style byte-level BPE (encode via iterative lowest-rank pair merges,
    decode via rank->bytes), compatible with both public vocab formats:
      - tiktoken ranks files (base64 token + rank per line), and
      - HuggingFace vocab.json + merges.txt;
  * the Whisper special-token layout (eot/sot/languages/tasks/timestamps),
    derived from WhisperConfig (SOT 50258, languages 50259..50357);
  * a self-contained byte-fallback vocab so every pipeline stage runs in
    asset-free environments (tests, benchmarks); real transcripts require a
    real ranks file (see tools/convert.py --vocab).
"""

from __future__ import annotations

import base64
import functools
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .config import WhisperConfig

# Order matters: index i -> token id lang_token_start + i. Identical to the
# openai/whisper table. "yue" is the 100th language used by the large-v3
# family.
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "iw", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)

LANGUAGE_NAMES: Dict[str, str] = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "iw": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

# GPT-2 pre-tokenization pattern (needs the `regex` module for \p classes).
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def _pattern():
    import regex

    return regex.compile(_GPT2_PATTERN)


# ---------------------------------------------------------------------------
# Vocab loading
# ---------------------------------------------------------------------------

def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Parse a tiktoken ranks file: '<base64-token> <rank>' per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable-unicode byte mapping (for HF vocab.json format)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def load_hf_vocab(vocab_json: str, merges_txt: Optional[str] = None) -> Dict[bytes, int]:
    """HF byte-level vocab.json -> raw-bytes ranks (merges file unused: the
    rank order already encodes merge priority)."""
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)
    uni2byte = {c: b for b, c in _bytes_to_unicode().items()}
    ranks: Dict[bytes, int] = {}
    for token, rank in vocab.items():
        if token.startswith("<|") and token.endswith("|>"):
            continue  # specials are derived from the config layout
        try:
            ranks[bytes(uni2byte[c] for c in token)] = int(rank)
        except KeyError:
            continue
    return ranks


def load_hf_tokenizer_json(path: str) -> Dict[bytes, int]:
    """HF `tokenizer.json` (the single-file `tokenizers` format every HF
    whisper repo ships) -> raw-bytes ranks. The BPE vocab lives under
    model.vocab with the same printable-unicode byte aliasing as vocab.json;
    specials live in added_tokens and are derived from the config instead."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    model = data.get("model") or {}
    if model.get("type", "BPE") != "BPE" or "vocab" not in model:
        raise ValueError(f"{path}: not a byte-level BPE tokenizer.json")
    uni2byte = {c: b for b, c in _bytes_to_unicode().items()}
    ranks: Dict[bytes, int] = {}
    for token, rank in model["vocab"].items():
        if token.startswith("<|") and token.endswith("|>"):
            continue  # specials are derived from the config layout
        try:
            ranks[bytes(uni2byte[c] for c in token)] = int(rank)
        except KeyError:
            continue
    return ranks


def byte_fallback_ranks(n_base: int) -> Dict[bytes, int]:
    """Asset-free vocab: 256 single-byte tokens + inert filler ids.

    Gives a fully functional (if inefficient) tokenizer: any text round-trips
    as raw bytes. Filler ids (256..n_base-1) never match during BPE because
    their byte strings are unreachable multi-byte sentinels.
    """
    ranks = {bytes([i]): i for i in range(256)}
    for i in range(256, n_base):
        ranks[b"\x00\xffFILLER" + str(i).encode()] = i
    return ranks


# ---------------------------------------------------------------------------
# BPE core
# ---------------------------------------------------------------------------

def _bpe_merge(word: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Merge bytes of one pre-token into ids by iterative lowest-rank pairs
    (tiktoken semantics: candidate pair merges iff the concatenation exists)."""
    parts: List[bytes] = [bytes([b]) for b in word]
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    out = []
    for p in parts:
        if p not in ranks:
            raise ValueError(f"byte sequence {p!r} not in vocab")
        out.append(ranks[p])
    return out


@dataclass
class Tokenizer:
    """Whisper tokenizer bound to one model config."""

    cfg: WhisperConfig
    ranks: Dict[bytes, int]
    language: Optional[str] = None
    task: str = "transcribe"
    _decoder: Dict[int, bytes] = field(init=False, repr=False)
    _cache: Dict[str, List[int]] = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        self._decoder = {rank: tok for tok, rank in self.ranks.items()}
        if self.language is not None and self.language not in self.languages:
            raise ValueError(f"unsupported language {self.language!r}")
        if self.task not in ("transcribe", "translate"):
            raise ValueError(f"unsupported task {self.task!r}")

    # -- special ids (delegated to config) ----------------------------------
    @property
    def eot(self) -> int:
        return self.cfg.eot_token

    @property
    def sot(self) -> int:
        return self.cfg.sot_token

    @property
    def translate(self) -> int:
        return self.cfg.translate_token

    @property
    def transcribe(self) -> int:
        return self.cfg.transcribe_token

    @property
    def sot_lm(self) -> int:
        return self.cfg.sot_lm_token

    @property
    def sot_prev(self) -> int:
        return self.cfg.sot_prev_token

    @property
    def no_speech(self) -> int:
        return self.cfg.no_speech_token

    @property
    def no_timestamps(self) -> int:
        return self.cfg.no_timestamps_token

    @property
    def timestamp_begin(self) -> int:
        return self.cfg.timestamp_begin

    @property
    def languages(self) -> Tuple[str, ...]:
        return LANGUAGES[: self.cfg.n_langs]

    def language_token(self, code: str) -> int:
        try:
            return self.cfg.lang_token_start + self.languages.index(code)
        except ValueError:
            raise ValueError(f"unsupported language {code!r}") from None

    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        """[sot, <lang>, <task>] (multilingual) or [sot] (.en models)."""
        if not self.cfg.multilingual:
            return (self.sot,)
        lang = self.language or "en"
        task_tok = self.transcribe if self.task == "transcribe" else self.translate
        return (self.sot, self.language_token(lang), task_tok)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return self.sot_sequence + (self.no_timestamps,)

    # -- encode / decode ----------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _pattern().findall(text):
            key = piece
            cached = self._cache.get(key)
            if cached is None:
                cached = _bpe_merge(piece.encode("utf-8"), self.ranks)
                self._cache[key] = cached
            ids.extend(cached)
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        """Decode, skipping ALL special tokens (timestamps included)."""
        pieces = []
        for t in tokens:
            t = int(t)
            if t < self.cfg.n_base_tokens:
                pieces.append(self._decoder.get(t, b""))
        return b"".join(pieces).decode("utf-8", errors="replace")

    def decode_with_timestamps(self, tokens: Sequence[int]) -> str:
        pieces = []
        run: List[int] = []

        def flush():
            if run:
                pieces.append(self.decode(run))
                run.clear()

        for t in tokens:
            t = int(t)
            if t >= self.timestamp_begin:
                flush()
                pieces.append(f"<|{self.timestamp_to_seconds(t):.2f}|>")
            else:
                run.append(t)
        flush()
        return "".join(pieces)

    def timestamp_to_seconds(self, token: int) -> float:
        return (int(token) - self.timestamp_begin) * 0.02

    def special_name(self, token: int) -> Optional[str]:
        t = int(token)
        if t < self.cfg.n_base_tokens:
            return None
        if t == self.eot:
            return "<|endoftext|>"
        if t == self.sot:
            return "<|startoftranscript|>"
        if self.cfg.lang_token_start <= t < self.cfg.lang_token_start + self.cfg.n_langs:
            return f"<|{LANGUAGES[t - self.cfg.lang_token_start]}|>"
        if t == self.translate:
            return "<|translate|>"
        if t == self.transcribe:
            return "<|transcribe|>"
        if t == self.sot_lm:
            return "<|startoflm|>"
        if t == self.sot_prev:
            return "<|startofprev|>"
        if t == self.no_speech:
            return "<|nospeech|>"
        if t == self.no_timestamps:
            return "<|notimestamps|>"
        return f"<|{self.timestamp_to_seconds(t):.2f}|>"

    # -- suppression sets (openai-compatible) -------------------------------
    @functools.cached_property
    def is_byte_fallback(self) -> bool:
        """True for the asset-free vocab (every byte is its own token)."""
        return all(self.ranks.get(bytes([i])) == i for i in range(256))

    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids for sound-effect/music annotations and stray symbols that
        should never be emitted (openai's tokenizer.non_speech_tokens).

        openai's rule adds tokens[0] of MULTI-token encodings for the music
        symbols ("or symbol in miscellaneous"). That first token is a merged
        symbol prefix under a real BPE vocab, but under the byte-fallback
        vocab it collapses to a raw byte: " ♪" -> byte 32 (which would
        suppress EVERY space for the whole decode) and "♪" -> byte 226 (the
        UTF-8 lead byte of all of U+0800..U+FFFF — all CJK). In byte-fallback
        mode only complete single-token symbols are therefore suppressed;
        real-vocab behaviour is unchanged."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        first_token_ok = not self.is_byte_fallback

        result = set()
        for t in [self.encode(" -"), self.encode(" '")]:
            if len(t) == 1:
                result.add(t[0])
        for symbol in symbols + list(miscellaneous):
            for tok_seq in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tok_seq) == 1 or (first_token_ok
                                         and symbol in miscellaneous):
                    if tok_seq:
                        result.add(tok_seq[0])
        return tuple(sorted(result))

    @functools.cached_property
    def blank_tokens(self) -> Tuple[int, ...]:
        """Ids encoding ' ' — suppressed at the first sampling position.

        Empty in byte-fallback mode: under a real BPE vocab a transcript's
        first token is a merged space-prefixed word (so a BARE space is
        degenerate and openai suppresses it), but byte-fallback transcripts
        legitimately START with the space byte — suppressing it forces every
        decode off-distribution at step 1 (EOT is still blocked there by
        decoding.build_blank_mask)."""
        if self.is_byte_fallback:
            return ()
        return tuple(self.encode(" "))


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

_VOCAB_ENV = "WHISPER_TPU_VOCAB"


def find_vocab_file(cfg: WhisperConfig) -> Optional[str]:
    """Locate a ranks/vocab asset: $WHISPER_TPU_VOCAB, or assets/ in-repo."""
    candidates = []
    if os.environ.get(_VOCAB_ENV):
        candidates.append(os.environ[_VOCAB_ENV])
    here = os.path.dirname(os.path.abspath(__file__))
    stem = "multilingual" if cfg.multilingual else "gpt2"
    candidates += [
        os.path.join(here, "assets", f"{stem}.tiktoken"),
        os.path.join(here, "assets", "vocab.json"),
        os.path.join(here, "assets", "tokenizer.json"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def get_tokenizer(
    cfg: WhisperConfig,
    *,
    language: Optional[str] = None,
    task: str = "transcribe",
    vocab_path: Optional[str] = None,
) -> Tokenizer:
    """Build a Tokenizer for `cfg`, loading the best available vocab.

    Resolution order: explicit path -> $WHISPER_TPU_VOCAB / bundled assets ->
    byte-fallback (functional, but transcripts are only byte-faithful, not
    BPE-identical to openai's).
    """
    path = vocab_path or find_vocab_file(cfg)
    if path is None:
        ranks = byte_fallback_ranks(cfg.n_base_tokens)
    elif os.path.basename(path) == "tokenizer.json":
        ranks = load_hf_tokenizer_json(path)
    elif path.endswith(".json"):
        # vocab.json (flat token->id map) vs tokenizer.json passed under a
        # different name: sniff the structure
        with open(path, encoding="utf-8") as f:
            head = json.load(f)
        # Sniff on STRUCTURE, not key presence: a genuine vocab.json maps
        # token strings to int ids and real GPT-2/Whisper vocabs contain the
        # literal token "model", so `"model" in head` would misroute them.
        if (
            isinstance(head, dict)
            and isinstance(head.get("model"), dict)
            and "vocab" in head["model"]
        ):
            ranks = load_hf_tokenizer_json(path)
        else:
            ranks = load_hf_vocab(path)
    else:
        ranks = load_tiktoken_ranks(path)
    return Tokenizer(cfg=cfg, ranks=ranks, language=language, task=task)
