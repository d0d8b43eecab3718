"""Dataset helpers (port of `eval/`): corpus discovery for fine-tuning.

`evaluate`, WER and the text normalizers are not ported yet (ROADMAP.md).
"""
