"""Dataset evaluation harness: WER + RTFx over a local corpus (port of
`eval/harness.py`).

    python -m openai_whisper_coreml_tpu_torch.eval.harness <corpus>
        [--model tiny] [--checkpoint f.safetensors] [--limit N]
        [--batch-size 8] [--language en] [--json] [--device cpu]

Datasets are local directories, in one of two layouts:

  * LibriSpeech: <root>/<spk>/<chap>/<spk>-<chap>-<utt>.flac|.wav with a
    <spk>-<chap>.trans.txt listing "<id> <TRANSCRIPT>" per line;
  * flat: pairs of <name>.wav + <name>.txt.

`evaluate` transcribes the corpus through `serve.transcribe_batch` and
scores it with `eval/wer.py` (CER for the space-less languages). The model
runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from ..utils.audio_io import load_audio_batch
from .wer import compute_wer


@dataclass
class Utterance:
    utt_id: str
    audio_path: str
    reference: str


def iter_librispeech(root: str) -> Iterator[Utterance]:
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        trans = [f for f in filenames if f.endswith(".trans.txt")]
        for tf in trans:
            with open(os.path.join(dirpath, tf), encoding="utf-8") as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    if not utt_id:
                        continue
                    for ext in (".flac", ".wav"):
                        p = os.path.join(dirpath, utt_id + ext)
                        if os.path.exists(p):
                            yield Utterance(utt_id, p, text)
                            break


def iter_flat(root: str) -> Iterator[Utterance]:
    for name in sorted(os.listdir(root)):
        if not name.endswith(".wav"):
            continue
        txt = os.path.join(root, os.path.splitext(name)[0] + ".txt")
        if os.path.exists(txt):
            with open(txt, encoding="utf-8") as f:
                yield Utterance(name, os.path.join(root, name),
                                f.read().strip())


def discover(root: str) -> List[Utterance]:
    utts = list(iter_flat(root))
    if not utts:
        utts = list(iter_librispeech(root))
    return utts


def evaluate(
    model,
    dataset_root: str,
    *,
    limit: Optional[int] = None,
    batch_size: int = 8,
    language: Optional[str] = "en",
    **serve_kwargs,
) -> Dict:
    """Run batched transcription over a corpus; returns WER + RTFx report."""
    import torch

    from ..config import SAMPLE_RATE
    from ..serve import ServeOptions, transcribe_batch

    utts = discover(dataset_root)
    if not utts:
        raise FileNotFoundError(f"no utterances found under {dataset_root}")
    if limit is not None:  # --limit 0 means none, not unbounded
        utts = utts[:limit]

    # the native threaded batch loader (native/audio_io.cpp wa_load_batch),
    # serial decode without the native library
    audios = load_audio_batch([u.audio_path for u in utts])
    total_audio_sec = sum(len(a) for a in audios) / SAMPLE_RATE

    opts = ServeOptions(batch_size=batch_size, language=language,
                        **serve_kwargs)
    on_card = model.device.type == "cuda"
    # warm up outside the timed window: the first batch pays kernel builds
    # and the allocator's first growth, which would understate RTFx on small
    # --limit runs
    transcribe_batch(model, audios[: min(2, len(audios))], opts)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = transcribe_batch(model, audios, opts)
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    hyps = [r["text"] for r in results]
    refs = [u.reference for u in utts]
    # space-less scripts report CER (word segmentation is ill-defined);
    # everything else reports WER, as openai/whisper does
    spaceless = {"zh", "ja", "th", "lo", "my", "yue"}
    if language in spaceless:
        from .wer import compute_cer

        score = compute_cer(refs, hyps, language=language)
        rename = {"wer": "cer", "ref_words": "ref_chars"}
        score_dict = {rename.get(k, k): v
                      for k, v in score.as_dict().items()}
    else:
        score_dict = compute_wer(refs, hyps, language=language).as_dict()

    return {
        "n_utterances": len(utts),
        "audio_seconds": round(total_audio_sec, 2),
        "wall_seconds": round(elapsed, 2),
        "rtfx": round(total_audio_sec / max(elapsed, 1e-9), 2),
        **score_dict,
        "examples": [
            {"id": u.utt_id, "ref": r, "hyp": h}
            for u, r, h in list(zip(utts, refs, hyps))[:3]
        ],
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="WER/RTFx evaluation")
    ap.add_argument("dataset", help="corpus root (LibriSpeech or flat layout)")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--language", default="en")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .. import load_model

    model = load_model(args.model, checkpoint=args.checkpoint,
                       device=args.device)
    report = evaluate(model, args.dataset, limit=args.limit,
                      batch_size=args.batch_size, language=args.language)
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            if k != "examples":
                print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
