"""Evaluation (port of `eval/`): corpus discovery and `evaluate` (WER and
RTFx, `harness.py`), the WER/CER metrics (`wer.py`) and openai's text
normalisers (`normalizers.py`)."""

from .wer import WERResult, compute_wer, normalize_text  # noqa: F401
