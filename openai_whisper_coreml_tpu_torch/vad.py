"""Energy-based voice activity detection (VAD) for transcription pre-filtering
(a numpy copy of the JAX package's `vad.py`, which the port cannot import).

Neither the reference (which transcribes nothing) nor openai/whisper ships a
VAD; skipping non-speech before decoding is nevertheless one of the most-used
serving features in production Whisper stacks (it removes hallucination fuel
and wasted decode windows). Model-based VADs (silero) need weights the
package does not ship, so this is a self-contained adaptive ENERGY
detector: frame RMS in dB against a noise-floor-tracking threshold with
hysteresis-style duration rules. The output feeds transcribe()'s existing
clip_timestamps machinery (openai v20231117 semantics), so the decode path
is unchanged — VAD only chooses which audio reaches it.

Deliberately conservative defaults: generous padding and merge distances so
quiet speech onsets are not clipped; an energy VAD trades a little skipped
silence for never needing a model asset.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .config import SAMPLE_RATE


@dataclasses.dataclass(frozen=True)
class VadOptions:
    frame_ms: int = 30  # analysis window
    hop_ms: int = 10
    # speech threshold = max(noise_floor_db + onset_db, absolute_floor_db);
    # the noise floor is the 15th percentile of frame energy (tracks mic/
    # codec hiss), the absolute floor guards digital-silence recordings
    # where "floor + onset" would label dither as speech
    onset_db: float = 9.0
    absolute_floor_db: float = -55.0
    # frames above this are speech regardless of the adaptive threshold: a
    # buffer that is ALL speech has its "noise floor" at speech level, and
    # floor+onset would then classify everything as silence (found by the
    # streaming vad_gate test on a constant tone)
    absolute_speech_db: float = -33.0
    min_speech_ms: int = 150  # shorter bursts are clicks/pops
    min_silence_ms: int = 400  # shorter gaps merge into one span
    pad_ms: int = 150  # widen every span (unclipped onsets/tails)

    def __post_init__(self):
        if self.frame_ms <= 0 or self.hop_ms <= 0:
            raise ValueError("frame_ms and hop_ms must be positive")
        if self.hop_ms > self.frame_ms:
            raise ValueError("hop_ms must not exceed frame_ms")


def _frame_energy_db(audio: np.ndarray, frame: int, hop: int) -> np.ndarray:
    """(n_frames,) RMS energy in dBFS; short tails count as zero-padded.

    O(n) memory via a cumulative sum of squares — the serving path runs
    this on whole uploads (hours of audio), where a materialised
    (n_frames, frame) window matrix would cost ~60 bytes/sample."""
    n = len(audio)
    if n == 0:
        return np.zeros((0,), np.float32)
    n_frames = max(1, 1 + (max(0, n - frame) + hop - 1) // hop)
    csum = np.concatenate(
        ([0.0], np.cumsum(np.square(audio, dtype=np.float64))))
    starts = np.minimum(np.arange(n_frames, dtype=np.int64) * hop, n)
    ends = np.minimum(starts + frame, n)
    sums = csum[ends] - csum[starts]
    rms = np.sqrt(sums / frame + 1e-12)  # /frame == zero-padded tail mean
    return (20.0 * np.log10(rms + 1e-12)).astype(np.float32)


def detect_speech(audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                  options: VadOptions = VadOptions()
                  ) -> List[Tuple[float, float]]:
    """Return merged (start_s, end_s) speech spans for mono float audio."""
    audio = np.asarray(audio, np.float32)
    frame = int(sample_rate * options.frame_ms / 1000)
    hop = int(sample_rate * options.hop_ms / 1000)
    energy = _frame_energy_db(audio, frame, hop)
    if energy.size == 0:
        return []

    noise_floor = float(np.percentile(energy, 15))
    threshold = max(noise_floor + options.onset_db,
                    options.absolute_floor_db)
    active = (energy > threshold) | (energy > options.absolute_speech_db)
    if not active.any():
        return []

    hop_s = hop / sample_rate
    # raw runs of active frames -> (start_s, end_s)
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], active, [False])).astype(np.int8)))
    spans = [(edges[i] * hop_s, edges[i + 1] * hop_s + options.frame_ms / 1000)
             for i in range(0, len(edges), 2)]

    # drop clicks/pops BEFORE padding (padding would gross a 50 ms click
    # past any sensible min_speech threshold)
    min_speech = options.min_speech_ms / 1000
    spans = [sp for sp in spans if sp[1] - sp[0] >= min_speech]

    pad = options.pad_ms / 1000
    duration = len(audio) / sample_rate
    spans = [(max(0.0, s - pad), min(duration, e + pad)) for s, e in spans]

    # merge spans separated by less than min_silence
    min_sil = options.min_silence_ms / 1000
    merged: List[Tuple[float, float]] = []
    for s, e in spans:
        if merged and s - merged[-1][1] < min_sil:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))

    return [(round(s, 3), round(e, 3)) for s, e in merged]


def speech_clip_timestamps(audio: np.ndarray,
                           sample_rate: int = SAMPLE_RATE,
                           options: VadOptions = VadOptions()) -> List[float]:
    """Speech spans flattened to transcribe()'s clip_timestamps format
    ([start, end, start, end, ...] seconds). Empty list = no speech."""
    return [t for span in detect_speech(audio, sample_rate, options)
            for t in span]
