"""Command-line interface: `python -m openai_whisper_coreml_tpu_torch`
(port of `cli.py`).

Files of any length in, transcripts out (txt/srt/vtt/tsv/json), or language
ID with `--task lang-id`, or simulated real-time streaming with `--stream`
(1 s chunks through `stream.StreamingTranscriber`, confirmed text printed
as it comes; `--kv-dtype` and `--cache-dtype` apply to its decodes). The
flags are the JAX package's; `--checkpoint` reads a `.safetensors` file
(`python -m openai_whisper_coreml_tpu_torch.convert` writes one).
`--word-timestamps` attaches per-word timings (`timing.py`), which the
subtitle options (`--max-line-width`, `--max-line-count`,
`--max-words-per-line`, `--highlight-words`) and
`--hallucination-silence-threshold` act on. `--draft-model` (with
`--draft-checkpoint` and `--spec-k`) decodes speculatively with a draft
model sharing the tokenizer (`speculative.py`), in files and with
`--stream`. `--profile-dir` writes a torch.profiler trace of each file's
transcription (CPU ops and CUDA kernels; `utils/profiling.device_trace`).
`--tensor-parallel` above 1 raises with a message naming ROADMAP.md: its
module is not ported yet. Left
out is the JAX CLI's `--batch`, which it never reads. The models are built
on the card; without one, loading them raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from .config import APPEND_PUNCTUATIONS, PREPEND_PUNCTUATIONS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisper-torch",
        description="Whisper on PyTorch/CUDA: transcribe/translate/identify audio.",
    )
    p.add_argument("audio", nargs="+", help="audio file path(s) (WAV, or any "
                   "format when the native decoder is built)")
    p.add_argument("--model", default="tiny", help="model size name")
    p.add_argument("--checkpoint", default=None,
                   help="converted or fine-tuned .safetensors checkpoint")
    p.add_argument("--vocab", default=None,
                   help="tokenizer ranks file (tiktoken) or HF vocab.json")
    p.add_argument("--task", choices=("transcribe", "translate", "lang-id"),
                   default="transcribe")
    p.add_argument("--language", default=None,
                   help="language code; default: auto-detect")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--temperature-increment-on-fallback", type=float, default=0.2)
    p.add_argument("--best-of", type=int, default=None,
                   help="number of sampling candidates at temperature > 0")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--patience", type=float, default=None)
    p.add_argument("--length-penalty", type=float, default=None)
    p.add_argument("--suppress-tokens", default="-1",
                   help="comma-separated token ids to suppress; "
                        "'-1' = openai non-speech set")
    p.add_argument("--without-timestamps", action="store_true")
    p.add_argument("--prepend-punctuations", default=PREPEND_PUNCTUATIONS,
                   help="punctuation merged with the NEXT word "
                        "(word timestamps)")
    p.add_argument("--append-punctuations", default=APPEND_PUNCTUATIONS,
                   help="punctuation merged with the PREVIOUS word "
                        "(word timestamps)")
    p.add_argument("--word-timestamps", action="store_true",
                   help="attach per-word timings via cross-attention DTW")
    p.add_argument("--stream", action="store_true",
                   help="simulate real-time streaming over the file, "
                        "printing confirmed text incrementally")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler device trace here")
    p.add_argument("--no-condition-on-previous-text", action="store_true")
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--carry-initial-prompt", action="store_true",
                   help="prepend --initial-prompt to every window's prompt "
                        "instead of only the first")
    p.add_argument("--clip-timestamps", default="0",
                   help="comma-separated start,end,... offsets (s); only "
                        "audio inside these clips is transcribed")
    p.add_argument("--vad-filter", action="store_true",
                   help="skip non-speech via the adaptive energy VAD "
                        "(vad.py) before decoding")
    p.add_argument("--hallucination-silence-threshold", type=float,
                   default=None,
                   help="with --word-timestamps: skip silence longer than "
                        "this (s) around likely hallucinated segments")
    p.add_argument("--compression-ratio-threshold", type=float, default=2.4)
    p.add_argument("--logprob-threshold", type=float, default=-1.0)
    p.add_argument("--no-speech-threshold", type=float, default=0.6)
    p.add_argument("--highlight-words", action="store_true",
                   help="srt/vtt: one cue per word, active word underlined "
                        "(needs --word-timestamps)")
    p.add_argument("--max-line-width", type=int, default=None,
                   help="srt/vtt: wrap subtitle lines at this many chars "
                        "(needs --word-timestamps)")
    p.add_argument("--max-line-count", type=int, default=None,
                   help="srt/vtt: max lines per subtitle")
    p.add_argument("--max-words-per-line", type=int, default=None,
                   help="srt/vtt: max words per line")
    p.add_argument("--output-dir", "-o", default=".")
    p.add_argument("--output-format", "-f", default="txt",
                   choices=("txt", "srt", "vtt", "tsv", "json", "all"))
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                   help="activation dtype (default bfloat16)")
    p.add_argument("--quantize", choices=("int8",), default=None,
                   help="weights-only int8 linears")
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                   help="cross-attention K/V precision")
    p.add_argument("--cache-dtype", choices=("bf16", "int8"), default="bf16",
                   help="self-attention KV-cache precision")
    p.add_argument("--draft-model", default=None, metavar="NAME",
                   help="speculative decoding: a smaller model (e.g. "
                        "large-v3-turbo for large-v3) drafts --spec-k "
                        "tokens per target verify step; must share the "
                        "tokenizer")
    p.add_argument("--draft-checkpoint", default=None,
                   help="converted checkpoint for --draft-model")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per speculative verify step")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="N",
                   help="shard over N cards (not ported yet; 1 only)")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor-parallel > 1 (parallel/) is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1)")

    import torch

    from . import load_model
    from .audio import load_audio
    from .utils.writers import write_result

    if args.vocab:
        import os

        os.environ["WHISPER_TPU_VOCAB"] = args.vocab

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             None: None}[args.dtype]

    t0 = time.time()
    model = load_model(args.model, dtype=dtype, quantize=args.quantize,
                       checkpoint=args.checkpoint)
    draft = None
    if args.draft_model:
        from .speculative import check_pair

        draft = load_model(args.draft_model, dtype=dtype, quantize=args.quantize,
                           checkpoint=args.draft_checkpoint)
        check_pair(model.cfg, draft.cfg)
    if args.verbose:
        print(f"loaded {args.model} ({model.num_params / 1e6:.0f}M params) "
              f"on {model.device} in {time.time() - t0:.1f}s",
              file=sys.stderr)

    inc = args.temperature_increment_on_fallback
    if args.temperature > 0 or not inc:
        temperature = [args.temperature]
    else:
        temperature = list(np.arange(args.temperature, 1.0 + 1e-6, inc))

    from .utils.profiling import device_trace

    status = 0
    for path in args.audio:
        t0 = time.time()
        try:
            audio = load_audio(path)
        except (OSError, ValueError, EOFError) as e:  # EOFError: empty/truncated WAV header
            # per-file isolation: a missing or corrupt file must not end a
            # multi-file run
            print(f"{path}: skipped ({e})", file=sys.stderr)
            status = 1
            continue
        duration = len(audio) / 16_000

        if args.stream:
            from .stream import StreamingTranscriber

            st = StreamingTranscriber(model, language=args.language or "en",
                                      beam_size=args.beam_size,
                                      draft_model=draft, spec_k=args.spec_k)
            chunk = 16_000  # 1 s
            for off in range(0, len(audio), chunk):
                for ev in st.feed(audio[off:off + chunk]):
                    print(ev.text, end="", flush=True)
            for ev in st.finish():
                print(ev.text, flush=True)
            elapsed = time.time() - t0
            print(f"{path}: streamed {duration:.1f}s in {elapsed:.1f}s",
                  file=sys.stderr)
            continue

        if args.task == "lang-id":
            from .audio import pad_or_trim
            from .decoding import detect_language

            mel = model.log_mel(pad_or_trim(audio))
            codes, probs = detect_language(model, mel[None])
            top = sorted(probs[0].items(), key=lambda kv: -kv[1])[:5]
            print(f"{path}: {codes[0]}  "
                  + "  ".join(f"{c}={p:.3f}" for c, p in top))
            continue

        with device_trace(args.profile_dir):
            result = model.transcribe(
                audio,
                task=args.task,
                language=args.language,
                temperature=temperature,
                compression_ratio_threshold=args.compression_ratio_threshold,
                logprob_threshold=args.logprob_threshold,
                no_speech_threshold=args.no_speech_threshold,
                condition_on_previous_text=not args.no_condition_on_previous_text,
                initial_prompt=args.initial_prompt,
                carry_initial_prompt=args.carry_initial_prompt,
                without_timestamps=args.without_timestamps,
                word_timestamps=args.word_timestamps,
                prepend_punctuations=args.prepend_punctuations,
                append_punctuations=args.append_punctuations,
                clip_timestamps=args.clip_timestamps,
                vad_filter=args.vad_filter,
                hallucination_silence_threshold=(
                    args.hallucination_silence_threshold),
                verbose=args.verbose,
                best_of=args.best_of,
                beam_size=args.beam_size,
                patience=args.patience,
                length_penalty=args.length_penalty,
                suppress_tokens=args.suppress_tokens,
                kv_dtype=args.kv_dtype,
                cache_dtype=args.cache_dtype,
                draft_model=draft,
                spec_k=args.spec_k,
            )
        elapsed = time.time() - t0
        out = write_result(result, path, args.output_dir, args.output_format,
                           highlight_words=args.highlight_words,
                           max_line_width=args.max_line_width,
                           max_line_count=args.max_line_count,
                           max_words_per_line=args.max_words_per_line)
        rtfx = duration / elapsed if elapsed > 0 else float("inf")
        print(f"{path}: {duration:.1f}s audio in {elapsed:.1f}s "
              f"({rtfx:.1f}x realtime) -> {out}", file=sys.stderr)
    return status


if __name__ == "__main__":
    sys.exit(main())
