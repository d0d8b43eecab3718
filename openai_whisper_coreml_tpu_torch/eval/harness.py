"""Local corpora of (audio, transcript) pairs (port of `eval/harness.py`,
its corpus discovery only; `evaluate` with WER and RTFx is not ported yet).

Two layouts are accepted:

  * LibriSpeech: <root>/<spk>/<chap>/<spk>-<chap>-<utt>.flac|.wav with a
    <spk>-<chap>.trans.txt listing "<id> <TRANSCRIPT>" per line;
  * flat: pairs of <name>.wav + <name>.txt.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List


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
