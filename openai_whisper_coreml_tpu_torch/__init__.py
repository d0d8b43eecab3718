"""PyTorch/CUDA port of the Whisper framework in `openai_whisper_coreml_tpu`.

log-mel frontend (Hopper log-mel kernel) -> encoder (Hopper flash-attention
kernel) -> int8 or bf16 cross-KV -> greedy, sampled or beam KV-cached
decoding over a bf16 or int8 self-attention cache (Hopper single-query
attention kernels on every single-token step) with the timestamp rules,
language ID, long-form `transcribe`, word timestamps (`timing.py`, on
every entry point), speculative decoding with a draft model
(`speculative.py`, on every entry point), batched serving (`transcribe_batch`, static and
continuous schedulers, beam under both), streaming
(`StreamingTranscriber`, `MultiStreamTranscriber`), the HTTP server
(`python -m openai_whisper_coreml_tpu_torch.serve_http`), the CLI
(`python -m openai_whisper_coreml_tpu_torch`, with `--profile-dir` for a
torch.profiler trace), checkpoint conversion
(`python -m openai_whisper_coreml_tpu_torch.convert`) and corpus
evaluation (`eval.harness.evaluate`: WER and RTFx). Imports torch,
never JAX; the JAX package is the reference it is tested against.
"""

__version__ = "0.1.0"

from .config import CONFIGS, WhisperConfig, get_config  # noqa: F401
from .audio import load_audio, log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import (DecodingOptions, DecodingResult, decode,  # noqa: F401
                       detect_language)
from .models.whisper import WhisperModel, build_model, load_model  # noqa: F401
from .serve import ServeOptions, transcribe_batch  # noqa: F401
from .speculative import check_pair, spec_decode_core, spec_stats  # noqa: F401
from .stream import (MultiStreamTranscriber, StreamEvent,  # noqa: F401
                     StreamingTranscriber)
from .tokenizer import get_tokenizer  # noqa: F401
from .transcribe import transcribe  # noqa: F401


def available_models():
    """Names accepted by load_model."""
    return sorted(CONFIGS)
