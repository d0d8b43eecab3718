"""PyTorch/CUDA port of the Whisper framework in `openai_whisper_coreml_tpu`.

log-mel frontend -> encoder (Hopper flash-attention kernel) -> int8 or bf16
cross-KV -> greedy KV-cached decoding with the timestamp rules, plus
language ID. Imports torch, never JAX; the JAX package is the reference it
is tested against.
"""

__version__ = "0.1.0"

from .config import CONFIGS, WhisperConfig, get_config  # noqa: F401
from .audio import log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import (DecodingOptions, DecodingResult, decode,  # noqa: F401
                       detect_language)
from .models.whisper import WhisperModel, build_model, load_model  # noqa: F401
from .tokenizer import get_tokenizer  # noqa: F401


def available_models():
    """Names accepted by load_model."""
    return sorted(CONFIGS)
