"""Model/audio configuration of the PyTorch port.

A framework-free copy of `openai_whisper_coreml_tpu/config.py`: importing
that package pulls in JAX, which the port's machine does not have. Every
size from tiny to large-v3-turbo is a frozen dataclass; tests hold the two
copies equal field by field.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Audio geometry (fixed across all Whisper sizes).
# 30 s of 16 kHz audio, framed with a 400-point FFT and a 160-sample hop into
# exactly 3000 frames.
# ---------------------------------------------------------------------------
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples per 30 s chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per chunk

# Encoder downsamples 2x via the strided conv stem -> 1500 audio positions.
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 mel frames / s
TOKENS_PER_SECOND = FRAMES_PER_SECOND // 2  # 50 audio tokens / s

# Word-timestamp punctuation defaults (openai/whisper transcribe):
# prepended chars glue onto the FOLLOWING word, appended onto the PREVIOUS.
# Single source of truth for timing.py / transcribe() / the CLI flags.
PREPEND_PUNCTUATIONS = "\"'\u201c\u00bf([{-"
APPEND_PUNCTUATIONS = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Static hyper-parameters of one Whisper model size.

    mel (n_mels, 3000) in, audio context (1500, n_audio_state), for the
    whole Whisper family.
    """

    name: str
    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    # Number of <|xx|> language tokens following <|startoftranscript|>.
    # 99 for the classic multilingual models (logits[50259...50357]);
    # large-v3 adds "yue" -> 100.
    n_langs: int = 99
    multilingual: bool = True

    # ---- derived dims -----------------------------------------------------
    @property
    def audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    # ---- special token ids ------------------------------------------------
    # Multilingual vocab layout: 50257 BPE ranks, then specials; so
    # eot=50257, sot=50258, languages 50259..
    # English-only (".en") layout: 50256 BPE ranks -> eot=50256, sot=50257.
    @property
    def n_base_tokens(self) -> int:
        return 50257 if self.multilingual else 50256

    @property
    def eot_token(self) -> int:
        return self.n_base_tokens

    @property
    def sot_token(self) -> int:
        return self.eot_token + 1

    @property
    def lang_token_start(self) -> int:
        return self.sot_token + 1

    @property
    def translate_token(self) -> int:
        return self.lang_token_start + self.n_langs

    @property
    def transcribe_token(self) -> int:
        return self.translate_token + 1

    @property
    def sot_lm_token(self) -> int:
        return self.transcribe_token + 1

    @property
    def sot_prev_token(self) -> int:
        return self.sot_lm_token + 1

    @property
    def no_speech_token(self) -> int:
        return self.sot_prev_token + 1

    @property
    def no_timestamps_token(self) -> int:
        return self.no_speech_token + 1

    @property
    def timestamp_begin(self) -> int:
        """Token id of <|0.00|>; timestamps run to <|30.00|> in 0.02 s steps."""
        return self.no_timestamps_token + 1

    @property
    def n_timestamps(self) -> int:
        return 1501

    def validate(self) -> None:
        expected_vocab = self.timestamp_begin + self.n_timestamps
        if expected_vocab != self.n_vocab:
            raise ValueError(
                f"{self.name}: vocab layout mismatch: computed {expected_vocab}"
                f" != configured {self.n_vocab}"
            )
        assert self.n_audio_state % self.n_audio_head == 0
        assert self.n_text_state % self.n_text_head == 0


def _cfg(name, mels, vocab, a_state, a_head, a_layer, t_layer=None, *, langs=99,
         multilingual=True) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_mels=mels,
        n_vocab=vocab,
        n_audio_ctx=1500,
        n_audio_state=a_state,
        n_audio_head=a_head,
        n_audio_layer=a_layer,
        n_text_ctx=448,
        n_text_state=a_state,
        n_text_head=a_head,
        n_text_layer=a_layer if t_layer is None else t_layer,
        n_langs=langs,
        multilingual=multilingual,
    )


# Dims table for the whole family; large-v3 has 128 mels, vocab 51866 and
# 100 languages.
CONFIGS = {
    "tiny": _cfg("tiny", 80, 51865, 384, 6, 4),
    "tiny.en": _cfg("tiny.en", 80, 51864, 384, 6, 4, multilingual=False),
    "base": _cfg("base", 80, 51865, 512, 8, 6),
    "base.en": _cfg("base.en", 80, 51864, 512, 8, 6, multilingual=False),
    "small": _cfg("small", 80, 51865, 768, 12, 12),
    "small.en": _cfg("small.en", 80, 51864, 768, 12, 12, multilingual=False),
    "medium": _cfg("medium", 80, 51865, 1024, 16, 24),
    "medium.en": _cfg("medium.en", 80, 51864, 1024, 16, 24, multilingual=False),
    "large": _cfg("large", 80, 51865, 1280, 20, 32),
    "large-v1": _cfg("large-v1", 80, 51865, 1280, 20, 32),
    "large-v2": _cfg("large-v2", 80, 51865, 1280, 20, 32),
    "large-v3": _cfg("large-v3", 128, 51866, 1280, 20, 32, langs=100),
    "large-v3-turbo": _cfg("large-v3-turbo", 128, 51866, 1280, 20, 32, t_layer=4,
                           langs=100),
    "turbo": _cfg("turbo", 128, 51866, 1280, 20, 32, t_layer=4, langs=100),
    # distil-whisper family (huggingface.co/distil-whisper): the teacher's
    # encoder with a 2-layer decoder — the decode loop unrolls per t_layer,
    # so these specialise to very short decode chains (same mechanism the
    # turbo configs use). Checkpoints load through tools/convert.py's HF
    # path (dims auto-detected and checked against this table).
    "distil-large-v3": _cfg("distil-large-v3", 128, 51866, 1280, 20, 32,
                            t_layer=2, langs=100),
    "distil-large-v2": _cfg("distil-large-v2", 80, 51865, 1280, 20, 32,
                            t_layer=2),
    "distil-medium.en": _cfg("distil-medium.en", 80, 51864, 1024, 16, 24,
                             t_layer=2, multilingual=False),
    "distil-small.en": _cfg("distil-small.en", 80, 51864, 768, 12, 12,
                            t_layer=4, multilingual=False),
}


def get_config(name: str) -> WhisperConfig:
    try:
        cfg = CONFIGS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(CONFIGS)}"
        ) from None
    cfg.validate()
    return cfg


def tiny_test_config(
    n_mels: int = 80,
    n_vocab: int = 51865,
    n_state: int = 64,
    n_head: int = 2,
    n_layer: int = 2,
    n_audio_ctx: int = 1500,
    n_text_ctx: int = 448,
) -> WhisperConfig:
    """A miniature config for fast CPU tests (real vocab layout, tiny widths)."""
    return WhisperConfig(
        name="test",
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_ctx=n_audio_ctx,
        n_audio_state=n_state,
        n_audio_head=n_head,
        n_audio_layer=n_layer,
        n_text_ctx=n_text_ctx,
        n_text_state=n_state,
        n_text_head=n_head,
        n_text_layer=n_layer,
    )


@dataclasses.dataclass(frozen=True)
class UniMoEConfig:
    """Static hyper-parameters of an audio language model built on a
    Whisper encoder (Uni-MoE-2.0-Omni's audio path, `models/audio_lm.py`).

    The Whisper encoder's `n_audio_*` widths and `n_mels`; a connector that
    pools its 1500 frames to `audio_tokens` and projects them to `hidden`;
    a Qwen2-style decoder of `n_layer` layers (GQA: `n_head` query heads
    and `n_kv_head` key/value heads of `hidden / n_head`, RMSNorm, RoPE),
    each with a mixture of experts: `n_experts` routed SwiGLU experts of
    `expert_ffn` and `n_null_experts` null experts under a top-p router
    (`top_p`, at most `top_k` picks), plus `n_shared` shared SwiGLU experts
    of `shared_ffn` added with weight 1; an untied head over `n_vocab`.
    """

    name: str
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    audio_tokens: int
    hidden: int
    n_layer: int
    n_head: int
    n_kv_head: int
    n_vocab: int
    n_experts: int
    n_null_experts: int
    expert_ffn: int
    top_p: float
    top_k: int
    n_shared: int
    shared_ffn: int
    rms_eps: float = 1e-6
    rope_theta: float = 1e6

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_head

    @property
    def n_routes(self) -> int:
        """The router's outputs: the routed experts, then the null ones."""
        return self.n_experts + self.n_null_experts

    @property
    def encoder_config(self) -> WhisperConfig:
        """The encoder's widths as a WhisperConfig (its text side a copy of
        the audio side; only `models/encoder.AudioEncoder` reads it)."""
        return WhisperConfig(
            name=f"{self.name}.encoder", n_mels=self.n_mels, n_vocab=51866,
            n_audio_ctx=self.n_audio_ctx, n_audio_state=self.n_audio_state,
            n_audio_head=self.n_audio_head, n_audio_layer=self.n_audio_layer,
            n_text_ctx=448, n_text_state=self.n_audio_state,
            n_text_head=self.n_audio_head, n_text_layer=self.n_audio_layer, n_langs=100)

    def validate(self) -> None:
        assert self.hidden % self.n_head == 0 and self.n_head % self.n_kv_head == 0
        assert self.head_dim % 2 == 0
        assert 1 <= self.top_k <= self.n_routes and 0.0 < self.top_p <= 1.0
        assert self.n_audio_state % self.n_audio_head == 0


# HIT-TMG/Uni-MoE-2.0-Omni config.json: large-v3's encoder (128 mels, 32
# layers at 1280), 200 audio tokens, 28 decoder layers at 3584.
UNIMOE_CONFIGS = {
    "uni-moe-2.0-omni": UniMoEConfig(
        name="uni-moe-2.0-omni", n_mels=128, n_audio_ctx=1500, n_audio_state=1280,
        n_audio_head=20, n_audio_layer=32, audio_tokens=200, hidden=3584, n_layer=28,
        n_head=28, n_kv_head=4, n_vocab=152064, n_experts=4, n_null_experts=1,
        expert_ffn=18944, top_p=0.7, top_k=2, n_shared=2, shared_ffn=2368),
}


def tiny_unimoe_config() -> UniMoEConfig:
    """A miniature audio LM for CPU tests: `tiny_test_config`'s encoder
    (80 mels, 2 layers at 64), hidden 64 with 4 / 2 heads of 16, 2 layers,
    4 experts of 96 and a null one, 2 shared of 32, a vocabulary of 512."""
    enc = tiny_test_config()
    return UniMoEConfig(name="tiny-unimoe", n_mels=enc.n_mels, n_audio_ctx=enc.n_audio_ctx,
                        n_audio_state=enc.n_audio_state, n_audio_head=enc.n_audio_head,
                        n_audio_layer=enc.n_audio_layer, audio_tokens=20, hidden=64,
                        n_layer=2, n_head=4, n_kv_head=2, n_vocab=512, n_experts=4,
                        n_null_experts=1, expert_ffn=96, top_p=0.7, top_k=2, n_shared=2,
                        shared_ffn=32)
