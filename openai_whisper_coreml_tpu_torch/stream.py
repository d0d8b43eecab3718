"""Streaming transcription: incremental decoding with LocalAgreement (port
of `stream.py`).

A sliding window is re-decoded as audio arrives, and the longest common
prefix of the last `agreement` hypotheses is CONFIRMED (the LocalAgreement-n
policy), so emitted text never retracts.

Buffer policy: when the rolling buffer nears 30 s, confirmed text is
committed (it becomes the conditioning prompt) and the last ~10 s of audio
are kept as context for the unconfirmed tail. Streaming decodes run without
timestamps, so the kept audio cannot be cut exactly at the confirmed
boundary; re-transcription of emitted audio is suppressed by a one-shot
overlap check against the tail of emitted tokens (the first confirmation
after each trim).

On the card every tick's log-mel runs K4 and its encode K1; each decode
step runs K3 over the bf16 self-attention cache. Streaming decodes use a
bf16 cross-KV and cache, as JAX's do, so they never reach K6.
`draft_model` makes the tick decodes speculative (`speculative.py`; the
draft's single-token steps run K3 over its bf16 cache), under one
acceptance governor per stream, or one per tier for
`MultiStreamTranscriber`. `MultiStreamTranscriber` decodes the due streams'
windows as one batch without padding it to the stream count (JAX pads to
reuse one compiled graph; PyTorch runs eagerly, and rows do not interact).
Under a (data, model) mesh (`parallel/`) every rank runs the same stream:
each tick's decode goes through `decode`, which splits the rows over the
data groups and gathers the tokens on every rank, so every rank emits the
same events.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import speculative as spec_mod
from .audio import pad_or_trim
from .config import N_SAMPLES, SAMPLE_RATE
from .decoding import DecodingOptions, decode

# Per-tick decode-length buckets (JAX's: one compiled graph per bucket there;
# here they bound a tick's horizon by the audio it holds).
_SAMPLE_BUCKETS = (32, 64, 128, 224)


def _governor(model, draft_model, spec_k: int, batch: int):
    """The acceptance governor of a stream (batch 1) or a tier. Under a
    mesh it keeps its prior threshold: walls differ between ranks, and the
    ranks must take every branch alike."""
    if draft_model is None:
        return None
    return spec_mod.SpecGovernor(
        threshold=spec_mod.break_even_tokens_per_iter(spec_k, batch=batch),
        pinned=getattr(model, "mesh", None) is not None)


def _governed_decode(model, mel, options, draft, gov, sampled: bool = False):
    """decode() under the stream's governor; without a draft the call is
    the plain one, decode(model, mel, options)."""
    return spec_mod.governed_decode(
        gov, draft, lambda d: (decode(model, mel, options) if d is None
                               else decode(model, mel, options, draft=d)),
        sampled=sampled)


@dataclasses.dataclass
class StreamEvent:
    """A piece of newly-confirmed transcript."""

    text: str
    tokens: List[int]
    is_final: bool = False


class StreamingTranscriber:
    """Feed audio chunks; receive confirmed transcript increments.

        st = StreamingTranscriber(model, language="en")
        for chunk in audio_chunks:          # any size, float32 at 16 kHz
            for ev in st.feed(chunk):
                print(ev.text, end="", flush=True)
        for ev in st.finish():
            print(ev.text)
    """

    def __init__(
        self,
        model,
        *,
        language: Optional[str] = "en",
        task: str = "transcribe",
        agreement: int = 2,
        decode_interval: float = 1.0,
        sample_len: Optional[int] = None,
        temperature: float = 0.0,
        beam_size: Optional[int] = None,
        max_tokens_per_second: Optional[float] = 8.0,
        vad_gate: bool = False,
        draft_model=None,
        spec_k: int = 4,
    ) -> None:
        """max_tokens_per_second bounds each tick's decode horizon by the
        audio buffered (dense English speech is ~3-4 BPE tokens/s; 8/s is
        a 2x margin): a 2 s buffer decodes <= 32 tokens instead of the full
        224-token horizon. None always decodes the full horizon.

        vad_gate: skip a due tick when the rolling buffer holds no speech by
        the energy VAD (vad.py); the tick fires as soon as speech appears.

        draft_model: speculative decoding for the tick decodes (spec_k
        proposals per verify step), under this stream's acceptance governor:
        content the draft cannot predict would otherwise pay the
        below-break-even cost on every tick."""
        if agreement < 1:
            raise ValueError("agreement must be >= 1")
        self.model = model
        self.language = language
        self.agreement = agreement
        self.decode_interval = decode_interval
        self.max_tokens_per_second = max_tokens_per_second
        self.vad_gate = vad_gate
        self.draft_model = draft_model
        self._spec_gov = _governor(model, draft_model, spec_k, batch=1)
        self.opts = dict(
            task=task,
            language=language,
            temperature=temperature,
            sample_len=sample_len,
            beam_size=beam_size,
            without_timestamps=True,
            spec_k=spec_k,
        )
        self._buffer = np.zeros(0, np.float32)
        self._since_decode = 0  # samples fed since the last decode
        self._confirmed: List[int] = []  # confirmed tokens for the current buffer
        self._hyps: List[List[int]] = []  # recent hypotheses
        self._prompt: List[int] = []  # committed text (conditioning)
        self._emitted_tail: List[int] = []  # recent emitted ids (dedup)
        self._dedup_pending = False  # set by a trim that kept emitted audio
        self._tokenizer = None

    # -- internals -----------------------------------------------------------

    def _tok(self):
        if self._tokenizer is None:
            from .tokenizer import get_tokenizer

            self._tokenizer = get_tokenizer(
                self.model.cfg,
                language=self.language if self.model.cfg.multilingual else None)
        return self._tokenizer

    def _tick_sample_len(self) -> Optional[int]:
        """Decode horizon for this tick: the user's sample_len capped by the
        buffered audio's duration, rounded up to a bucket."""
        base = self.opts["sample_len"]
        if not self.max_tokens_per_second:
            return base
        secs = len(self._buffer) / SAMPLE_RATE
        need = int(np.ceil(secs * self.max_tokens_per_second)) + 8
        cap = next((b for b in _SAMPLE_BUCKETS if need <= b), None)
        if cap is None:
            return base
        return min(base, cap) if base else cap

    def _decode_window(self) -> List[int]:
        mel = self.model.log_mel(pad_or_trim(self._buffer))
        opts = dict(self.opts, sample_len=self._tick_sample_len())
        # one fixed temperature per stream: every tick is one regime
        res = _governed_decode(
            self.model, mel[None],
            DecodingOptions(prompt=self._prompt or None, **opts),
            self.draft_model, self._spec_gov,
            sampled=float(opts["temperature"] or 0.0) > 0)[0]
        return res.tokens

    @staticmethod
    def _common_prefix(seqs: List[List[int]]) -> List[int]:
        if not seqs:
            return []
        out = []
        for vals in zip(*seqs):
            if all(v == vals[0] for v in vals):
                out.append(vals[0])
            else:
                break
        return out

    def _confirm(self) -> List[int]:
        """Run one decode, update the hypothesis history, return the newly
        confirmed tokens."""
        return self._update_with_hyp(self._decode_window())

    def _update_with_hyp(self, hyp: List[int]) -> List[int]:
        """LocalAgreement update for one new hypothesis (the multi-stream
        tier decodes many windows in one batch and injects each stream's
        hypothesis here)."""
        self._hyps.append(hyp)
        self._hyps = self._hyps[-self.agreement:]
        if len(self._hyps) < self.agreement:
            return []
        prefix = self._common_prefix(self._hyps)
        if len(prefix) <= len(self._confirmed):
            return []
        new = prefix[len(self._confirmed):]
        self._confirmed = prefix
        return new

    def _maybe_trim(self) -> None:
        """Keep the rolling buffer under 30 s by committing confirmed text."""
        if len(self._buffer) <= N_SAMPLES - SAMPLE_RATE:  # 1 s headroom
            return
        if not self._confirmed:
            # nothing confirmed: hard-trim the oldest 10 s (content there
            # can no longer be confirmed once it leaves the window)
            self._buffer = self._buffer[10 * SAMPLE_RATE:]
            self._hyps.clear()
            return
        # commit everything confirmed and keep the last ~10 s of audio as
        # context for the unconfirmed tail; the kept audio may cover text
        # already emitted, so arm the one-shot overlap dedup
        self._prompt = (self._prompt + self._confirmed)[-(self.model.cfg.n_text_ctx // 2 - 1):]
        self._buffer = self._buffer[-10 * SAMPLE_RATE:]
        self._confirmed = []
        self._hyps.clear()
        self._dedup_pending = True

    def _make_event(self, new: List[int], final: bool = False) -> Optional[StreamEvent]:
        """Dedup (one-shot after a trim), record the emitted tail, build the
        event; None when nothing new survives."""
        if new and self._dedup_pending:
            tail = self._emitted_tail
            for k in range(min(len(tail), len(new)), 0, -1):
                if tail[-k:] == new[:k]:
                    new = new[k:]
                    break
            self._dedup_pending = False
        if not new:
            return None
        self._emitted_tail = (self._emitted_tail + new)[-64:]
        return StreamEvent(self._tok().decode(new), new, is_final=final)

    def _buffer_samples(self, samples: np.ndarray) -> None:
        """Append audio without a decode (the multi-stream tier decodes in
        poll())."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._since_decode += len(samples)

    def _vad_skip(self) -> bool:
        """True when vad_gate is on and the buffer holds no speech. A
        skipped tick also bounds the buffer to a 5 s onset-context tail, so
        long silences neither grow memory nor bury later speech."""
        if not self.vad_gate or not len(self._buffer):
            return False
        from .vad import detect_speech

        if detect_speech(self._buffer):
            return False
        keep = 5 * SAMPLE_RATE
        if len(self._buffer) > keep:
            self._buffer = self._buffer[-keep:]
            self._confirmed = []
            self._hyps.clear()
        return True

    # -- public API ----------------------------------------------------------

    def feed(self, samples: np.ndarray) -> List[StreamEvent]:
        """Append audio; returns newly confirmed transcript events."""
        self._buffer_samples(samples)
        events: List[StreamEvent] = []
        if self._since_decode >= self.decode_interval * SAMPLE_RATE:
            self._since_decode = 0
            if self._vad_skip():
                return events
            ev = self._make_event(self._confirm())
            if ev:
                events.append(ev)
            self._maybe_trim()
        return events

    def finish(self) -> List[StreamEvent]:
        """Flush: decode once more and emit everything unconfirmed. The
        final hypothesis only extends the output if it agrees with the
        confirmed prefix; on divergence nothing new is emitted."""
        hyp = self._decode_window() if len(self._buffer) else []
        lcp = len(self._common_prefix([hyp, self._confirmed])) if self._confirmed else 0
        if self._confirmed and lcp < len(self._confirmed):
            new: List[int] = []
        else:
            new = hyp[len(self._confirmed):]
            self._confirmed = hyp
        ev = self._make_event(new, final=True)
        return [ev] if ev else [StreamEvent("", [], is_final=True)]


class MultiStreamTranscriber:
    """Many live streams on one card: one BATCHED decode per tick.

    A StreamingTranscriber state machine per stream, but every due
    stream's window decodes in one batch, each row with its stream's own
    committed-text prompt (decoding's per-sample prompts).

        mst = MultiStreamTranscriber(model, n_streams=8, language="en")
        mst.feed(3, chunk)                   # buffer audio for stream 3
        for i, evs in mst.poll().items():    # one batched decode per call
            ...
        mst.finish(3)                        # flush one stream
    """

    def __init__(self, model, n_streams: int, *,
                 language: Optional[str] = "en", task: str = "transcribe",
                 agreement: int = 2,
                 decode_interval: float = 1.0,
                 sample_len: Optional[int] = None,
                 max_tokens_per_second: Optional[float] = 8.0,
                 condition_on_committed_text: bool = True,
                 vad_gate: bool = False,
                 draft_model=None,
                 spec_k: int = 4) -> None:
        """draft_model: speculative decoding for the batched tick decodes,
        under one tier-level acceptance governor (the batch mixes streams,
        so its evidence is the tier's)."""
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.model = model
        self.language = language
        self.condition_on_committed_text = condition_on_committed_text
        self.task = task
        self.spec_k = spec_k
        self.draft_model = draft_model
        self._spec_gov = _governor(model, draft_model, spec_k, batch=n_streams)
        self.streams = [
            StreamingTranscriber(
                model, language=language, task=task, agreement=agreement,
                decode_interval=decode_interval, sample_len=sample_len,
                max_tokens_per_second=max_tokens_per_second, vad_gate=vad_gate)
            for _ in range(n_streams)
        ]

    def feed(self, idx: int, samples: np.ndarray) -> None:
        """Buffer audio for one stream (no device work; see poll())."""
        self.streams[idx]._buffer_samples(samples)

    def poll(self) -> dict:
        """Decode every due stream in one batch; returns {stream index:
        [StreamEvent, ...]} for the streams with new text."""
        due = []
        for i, st in enumerate(self.streams):
            if st._since_decode >= st.decode_interval * SAMPLE_RATE and len(st._buffer):
                if st._vad_skip():
                    # silent stream: no batch row this tick (its clock is
                    # reset so speech re-arms the tick)
                    st._since_decode = 0
                    continue
                due.append(i)
        if not due:
            return {}
        # shared horizon: the largest due stream's duration cap
        caps = [self.streams[i]._tick_sample_len() for i in due]
        sample_len = None if any(c is None for c in caps) else max(caps)
        audio = np.stack([pad_or_trim(self.streams[i]._buffer) for i in due])
        prompts = [list(self.streams[i]._prompt) or None for i in due]
        mel = self.model.log_mel(audio)
        prompt_opt = (prompts if self.condition_on_committed_text and any(prompts)
                      else None)
        res = _governed_decode(self.model, mel, DecodingOptions(
            task=self.task, language=self.language, without_timestamps=True,
            prompt=prompt_opt, spec_k=self.spec_k, sample_len=sample_len),
            self.draft_model, self._spec_gov)

        events: dict = {}
        for i, r in zip(due, res):
            st = self.streams[i]
            st._since_decode = 0
            ev = st._make_event(st._update_with_hyp(list(r.tokens)))
            if ev:
                events[i] = [ev]
            st._maybe_trim()
        return events

    def finish(self, idx: int) -> List[StreamEvent]:
        """Flush one stream (a batch-1 decode; final text)."""
        return self.streams[idx].finish()
