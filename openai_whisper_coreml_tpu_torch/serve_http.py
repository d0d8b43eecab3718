"""Minimal HTTP serving front-end, stdlib only (port of `serve_http.py`):
python -m openai_whisper_coreml_tpu_torch.serve_http --model large-v3 \
    --quantize int8 --kv-dtype int8

POST /transcribe   body: WAV bytes (or float32 PCM with X-Raw-Audio: 1)
                   query: ?task=transcribe&language=en&beam_size=5
POST /detect       body: WAV bytes -> {"language": ..., "probs": {...}}
POST /stream       incremental: audio in (chunked transfer-encoding or a
                   plain body), confirmed-text NDJSON lines out (chunked)
POST /v1/audio/transcriptions   OpenAI-compatible: multipart/form-data with
POST /v1/audio/translations     file (WAV/FLAC), model, language, prompt,
                   temperature, response_format (json|text|srt|verbose_json|
                   vtt), timestamp_granularities[] (segment|word) — drop-in
                   for OpenAI SDK audio clients pointed at this base URL
GET  /v1/models     OpenAI model list (and /v1/models/<id>)
GET  /metrics      counters, gauges and latency summaries (JSON, or the
                   Prometheus text form with ?format=prometheus)
GET  /healthz      -> {"ok": true, "model": ..., "backend": ..., "warmed": ...}
                   ("backend" is the model's device type, "cuda" or "cpu")
GET  /readyz       -> 200 {"ready": true} once the startup warmup batch has
                   run (503 while it runs; 200 at once without warmup)

Requests are micro-batched: a background worker drains the queue every
`batch_window_ms` and decodes up to `batch_size` 30 s windows together
through serve.transcribe_batch. Word timestamps (`?word_timestamps=1`,
or `timestamp_granularities[]=word` with `verbose_json`) put `words` on
each segment, and the OpenAI route's answer carries them as `words`. A
failing batch answers its requests with the error and the server keeps
serving.

Threads: the batch worker decodes while handler threads run /detect and
/stream decodes of their own on the same model. PyTorch does not serialise
them as JAX does; they share the device's default stream, so the card runs
them in the order they are enqueued, and every kernel wrapper counts its
launches under a lock. With a paired draft (`--draft-model`, or
`model.draft` in-process) batches decode speculatively under the model's
acceptance governor and /stream ticks under one governor per stream;
/metrics then carries the speculative counters and the governor's gauges,
each batch's read as differences of `speculative.TOTALS`.

Under a (data, model) mesh (`--tensor-parallel N` under torchrun, or a
mesh model in-process) rank 0 runs this front end and the other ranks run
`follow`. Every call that touches the model is one command (`_execute`:
a batch, the warm-up, /detect, a /stream's open, feed and close), which
rank 0 broadcasts over the world and every rank runs, in one order: rank
0 issues its commands one at a time under a lock, so the collectives
inside them meet. A request that fails validation answers 4xx before
anything is sent; a command that raises raises on every rank, and each
rank carries on (rank 0 answers 500). While idle, rank 0 sends a no-op
every quarter of the process group's timeout, so the followers, blocked
in the broadcast, never time out; `stop()` sends the followers a stop.
Only rank 0 answers requests and keeps /metrics.

    torchrun --nproc-per-node N -m openai_whisper_coreml_tpu_torch.serve_http \
        --model large-v3 --quantize int8 --kv-dtype int8 --tensor-parallel N
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from .utils.obs import Metrics, get_logger, kv

log = get_logger("serve_http")
_req_ids = itertools.count(1)
_stream_ids = itertools.count(1)


# -- model commands ---------------------------------------------------------
# A command is a tuple (op, *args) of plain Python and numpy values: the
# same call on every rank of a mesh.

def _execute(model, streams: Dict[int, Any], cmd: tuple):
    """Run one command on this rank's model; `streams` holds the rank's
    StreamingTranscribers by stream id."""
    op, args = cmd[0], cmd[1:]
    if op == "batch":  # the batch worker's and the warm-up's call
        from . import serve

        audios, options = args
        return serve.transcribe_batch(model, audios, serve.ServeOptions(**options))
    if op == "detect":
        from .audio import pad_or_trim
        from .decoding import detect_language

        # the mel stays a tensor on the model's device
        mel = model.log_mel(pad_or_trim(args[0]))
        codes, probs = detect_language(model, mel[None])
        return codes[0], probs[0]
    if op == "stream_open":
        from .stream import StreamingTranscriber

        sid, kw = args
        # the server's paired draft speeds the tick decodes; the stream's
        # own governor handles low acceptance
        streams[sid] = StreamingTranscriber(
            model, draft_model=getattr(model, "draft", None), **kw)
        return None
    if op in ("stream_feed", "stream_finish"):
        sid = args[0]
        try:
            if op == "stream_feed":
                return streams[sid].feed(args[1])
            return streams.pop(sid).finish()
        except BaseException:
            streams.pop(sid, None)  # a failed stream is closed on every rank
            raise
    if op == "stream_close":
        streams.pop(args[0], None)
        return None
    if op == "noop":
        return None
    raise ValueError(f"unknown server command {op!r}")


def _broadcast(cmd: Optional[tuple]) -> tuple:
    """Rank 0's command, on every rank of the world."""
    import torch.distributed as dist

    box = [cmd]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(model) -> None:
    """A rank other than 0 of a mesh server: run rank 0's commands in its
    order until it stops. A command that raises here raised on rank 0 too
    (every rank runs the same call on the same inputs); it is logged, and
    the next command runs."""
    streams: Dict[int, Any] = {}
    while True:
        cmd = _broadcast(None)
        if cmd[0] == "stop":
            return
        try:
            _execute(model, streams, cmd)
        except Exception as e:
            log.warning("command failed %s", kv(
                op=cmd[0], error=f"{type(e).__name__}: {e}"))


@dataclass
class _Job:
    audio: np.ndarray
    options: Dict[str, Any]
    request_id: str = ""
    submitted: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    cancelled: bool = False  # set by a timed-out submit; worker skips it


class WhisperHTTPServer:
    def __init__(self, model, host: str = "127.0.0.1", port: int = 8090,
                 *, batch_size: int = 8, batch_window_ms: int = 50,
                 max_body_bytes: int = 512 * 1024 * 1024,
                 allow_origin: Optional[str] = None,
                 warmup: bool = False,
                 default_options: Optional[Dict[str, Any]] = None):
        """default_options: server-level ServeOptions fields (scheduler,
        kv_dtype, ...) applied under every request's own query options.
        max_body_bytes caps request bodies (413 beyond it): ~512 MB is over
        4 hours of 16-bit 16 kHz WAV — bigger uploads are almost certainly
        abuse, and reading them would hold gigabytes per handler thread.
        warmup: run one full-batch transcribe_batch over silence at startup
        (with the server's default options), so the first real request
        finds the kernels built and the card's libraries loaded; /readyz
        flips to 200 when done. Under a mesh this runs on rank 0 (the
        other ranks run `follow`), and while idle it sends a no-op command
        every quarter of the process group's timeout (`heartbeat_s`)."""
        self.model = model
        self._mesh = getattr(model, "mesh", None) is not None
        self._streams: Dict[int, Any] = {}
        self._model_lock = threading.Lock()  # one command at a time (mesh)
        self._released = False  # the followers were sent their stop
        if self._mesh:
            from .parallel.distributed import group_timeout_s, rank

            if rank() != 0:
                raise ValueError("a mesh server runs on rank 0; the other "
                                 "ranks run serve_http.follow(model)")
            self.heartbeat_s = group_timeout_s() / 4
        self.default_options = dict(default_options or {})
        self.batch_size = batch_size
        self.batch_window_ms = batch_window_ms
        self.max_body_bytes = max_body_bytes
        # CORS is OPT-IN: this server has no auth, so a wildcard default
        # would let any web page a local operator visits read transcripts
        # and metrics cross-origin. Set "*" (or an origin) to enable.
        self.allow_origin = allow_origin
        self.metrics = Metrics()
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._do_warmup = warmup
        self._warmed = threading.Event()
        if not warmup:
            self._warmed.set()  # no warmup requested: ready immediately

        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    # -- model commands -----------------------------------------------------

    def _call(self, *cmd):
        """Run one model command. Under a mesh it is broadcast first, under
        the lock that orders every rank's commands alike."""
        if not self._mesh:
            return _execute(self.model, self._streams, cmd)
        with self._model_lock:
            if self._released:
                raise RuntimeError("server shutting down")
            _broadcast(cmd)
            return _execute(self.model, self._streams, cmd)

    def _heartbeat(self) -> None:
        """A no-op command every heartbeat_s until stop (mesh only)."""
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._call("noop")
            except RuntimeError:  # released by stop()
                return

    def _release(self) -> None:
        """Send the followers their stop, once; later commands refuse."""
        with self._model_lock:
            if not self._released:
                self._released = True
                _broadcast(("stop",))

    def _close_stream(self, sid: int) -> None:
        """Drop a stream that its handler left open (a client that went
        away, a shutdown) on every rank."""
        if sid in self._streams:
            try:
                self._call("stream_close", sid)
            except RuntimeError:  # released: the followers are gone
                self._streams.pop(sid, None)

    def batch_options(self, options: Dict[str, Any]) -> Dict[str, Any]:
        """A request's ServeOptions fields over the server's defaults and
        its batch size, checked: raises ValueError or TypeError on options
        that ServeOptions refuses (the handlers answer 400 before any
        model work)."""
        from .serve import ServeOptions

        merged = {**self.default_options, **options, "batch_size": self.batch_size}
        ServeOptions(**merged)
        return merged

    # -- batching worker ----------------------------------------------------

    def _drain(self) -> None:
        from . import speculative

        while not self._stop.is_set():
            try:
                first = self._take(timeout=0.1)
            except queue.Empty:
                continue
            jobs = [first]
            # one ABSOLUTE window from the first job: per-get timeouts would
            # restart the clock per arrival (up to (batch-1) windows of
            # added latency under a trickle of requests)
            deadline = time.monotonic() + self.batch_window_ms / 1000.0
            try:
                while len(jobs) < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    jobs.append(self._take(timeout=remaining))
            except queue.Empty:
                pass
            jobs = [j for j in jobs if not j.cancelled]
            if not jobs:
                continue

            # group by identical decode options (one batch per option set)
            by_opts: Dict[str, list] = {}
            for j in jobs:
                by_opts.setdefault(json.dumps(j.options, sort_keys=True),
                                   []).append(j)
            for opts_key, group in by_opts.items():
                t0 = time.monotonic()
                audio_s = sum(len(j.audio) for j in group) / 16_000.0
                spec_before = dict(speculative.TOTALS)
                try:
                    results = self._call("batch", [j.audio for j in group],
                                         self.batch_options(json.loads(opts_key)))
                    for j, r in zip(group, results):
                        j.result = r
                except Exception as e:  # surface per-request, keep serving
                    for j in group:
                        j.error = f"{type(e).__name__}: {e}"
                    self.metrics.inc("batches_failed")
                    log.error("batch failed %s", kv(
                        requests=len(group), error=f"{type(e).__name__}: {e}"))
                else:
                    # success-only observations: a batch that died in 0.5 s
                    # with 300 s of queued audio must not inject rtfx=600
                    # into the latency/rtfx reservoirs
                    elapsed = time.monotonic() - t0
                    self.metrics.observe("batch_latency_s", elapsed)
                    if audio_s and elapsed > 0:
                        self.metrics.observe("batch_rtfx", audio_s / elapsed)
                    self._spec_metrics(speculative, spec_before)
                    log.info("batch done %s", kv(
                        requests=len(group), audio_s=round(audio_s, 2),
                        latency_s=round(elapsed, 3),
                        rtfx=round(audio_s / elapsed, 1) if elapsed else 0,
                        ids=",".join(j.request_id for j in group)))
                self.metrics.inc("batches_total")  # success + failed
                self.metrics.set_gauge("queue_depth", self._queue.qsize())
                for j in group:
                    j.done.set()

    def _take(self, timeout: float) -> _Job:
        """The next queued job; its wait in the queue, from `submit` until
        now, is observed as `queue_wait_s` (a request's latency is its
        queue wait, the batch window and the batch's work)."""
        job = self._queue.get(timeout=timeout)
        self.metrics.observe("queue_wait_s", time.monotonic() - job.submitted)
        return job

    def _spec_metrics(self, speculative, before: Dict[str, int]) -> None:
        """One batch's speculative counters and gauges: differences of
        `speculative.TOTALS` around the batch (the /stream handlers'
        decodes that ran meanwhile count in too), and the model's
        acceptance governor's verdicts and live break-even."""
        d_iters = speculative.TOTALS["iters"] - before["iters"]
        if d_iters > 0:  # this batch ran speculative decodes
            d_tok = speculative.TOTALS["tokens"] - before["tokens"]
            d_drf = speculative.TOTALS["drafted"] - before["drafted"]
            self.metrics.inc("spec_tokens", d_tok)
            self.metrics.inc("spec_iters", d_iters)
            self.metrics.set_gauge("spec_tokens_per_iter", d_tok / d_iters)
            if d_drf > 0:
                self.metrics.set_gauge("spec_acceptance_rate",
                                       (d_tok - d_iters) / d_drf)
        gov = getattr(self.model, "_spec_governor", None)
        if gov is not None:  # the acceptance governor's verdict
            self.metrics.set_gauge("spec_draft_active",
                                   0.0 if gov.disabled else 1.0)
            self.metrics.set_gauge("spec_draft_active_sampled",
                                   0.0 if gov.disabled_sampled else 1.0)
            # the threshold in force and the two walled cost terms behind
            # it (absent until each has evidence)
            self.metrics.set_gauge("spec_governor_threshold", gov.threshold)
            self.metrics.set_gauge("spec_governor_calibrated",
                                   1.0 if gov.calibrated else 0.0)
            if gov.live_iter_ms is not None:
                self.metrics.set_gauge("spec_live_ms_per_iter",
                                       gov.live_iter_ms)
            if gov.live_tok_ms is not None:
                self.metrics.set_gauge("spec_live_ms_per_token",
                                       gov.live_tok_ms)

    def _warmup(self) -> None:
        """Warm the serving path before real traffic: one full-batch
        transcribe_batch over silent windows with the server's default
        options, the call the drain worker makes, so the kernels are built
        and mel, encoder, language detection and decode have run once when
        /readyz goes green."""
        t0 = time.monotonic()
        try:
            silence = [np.zeros(16_000, np.float32)] * self.batch_size
            self._call("batch", silence, self.batch_options({}))
            log.info("warmup done %s", kv(
                batch=self.batch_size,
                seconds=round(time.monotonic() - t0, 1)))
        except Exception as e:  # stay serving: requests warm the path
            log.error("warmup failed %s", kv(
                error=f"{type(e).__name__}: {e}"))
        finally:
            self._warmed.set()

    # -- request handling ---------------------------------------------------

    def submit(self, audio: np.ndarray, options: Dict[str, Any],
               timeout: float = 300.0) -> _Job:
        job = _Job(audio=audio, options=options,
                   request_id=f"r{next(_req_ids)}", submitted=time.monotonic())
        if self._stop.is_set():
            # fail fast: the worker is gone, so an enqueue would strand the
            # caller for the full timeout (a submit can race stop()'s
            # one-shot queue drain — e.g. a handler mid-upload at shutdown)
            job.error = "server shutting down"
            job.done.set()
            return job
        self.metrics.inc("requests_total")
        self.metrics.set_gauge("queue_depth", self._queue.qsize() + 1)
        log.info("request queued %s", kv(
            id=job.request_id, audio_s=round(len(audio) / 16_000.0, 2),
            options=json.dumps(options, sort_keys=True)))
        self._queue.put(job)
        if not job.done.wait(timeout):
            # mark cancelled so the worker drops it instead of burning a
            # batch slot on an abandoned request; a completion that raced
            # the timeout still wins (done was set before we got here)
            job.cancelled = True
            if not job.done.is_set():
                job.error = "timeout"
                self.metrics.inc("requests_timeout")
        latency = time.monotonic() - job.submitted
        self.metrics.observe("request_latency_s", latency)
        if job.error:
            self.metrics.inc("requests_failed")
            log.warning("request failed %s", kv(id=job.request_id,
                                                error=job.error,
                                                latency_s=round(latency, 3)))
        else:
            log.info("request done %s", kv(id=job.request_id,
                                           latency_s=round(latency, 3)))
        return job

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer coding does not exist in HTTP/1.0: without
            # this, /stream's framing bytes would reach clients verbatim
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def do_OPTIONS(self):
                # CORS preflight: browser clients of the OpenAI-compatible
                # API send OPTIONS before multipart POSTs (only answered
                # with CORS headers when the server opted in)
                self.send_response(204)
                if server.allow_origin:
                    self._cors()
                    self.send_header("Access-Control-Allow-Methods",
                                     "GET, POST, OPTIONS")
                    self.send_header("Access-Control-Allow-Headers",
                                     "Content-Type, Authorization, "
                                     "X-Raw-Audio")
                    self.send_header("Access-Control-Max-Age", "86400")
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _cors(self) -> None:
                if server.allow_origin:
                    self.send_header("Access-Control-Allow-Origin",
                                     server.allow_origin)

            def _json(self, code: int, obj) -> None:
                def np_default(o):
                    if isinstance(o, (np.integer,)):
                        return int(o)
                    if isinstance(o, (np.floating,)):
                        return float(o)
                    raise TypeError(
                        f"not JSON serializable: {type(o).__name__}")

                body = json.dumps(obj, default=np_default).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self._cors()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._json(200, {"ok": True,
                                     "model": server.model.cfg.name,
                                     "backend": server.model.device.type,
                                     "warmed": server._warmed.is_set()})
                elif self.path.startswith("/readyz"):
                    # load-balancer readiness: 503 until the startup warmup
                    # batch finishes (200 immediately when warmup is off)
                    ready = server._warmed.is_set()
                    self._json(200 if ready else 503, {"ready": ready})
                elif self.path.startswith("/v1/models"):
                    # OpenAI SDK compatibility: model list + per-id
                    # retrieve (clients validate their configured model)
                    models = [
                        {"id": "whisper-1", "object": "model", "created": 0,
                         "owned_by": "openai-whisper-coreml-tpu"},
                        {"id": server.model.cfg.name, "object": "model",
                         "created": 0,
                         "owned_by": "openai-whisper-coreml-tpu"},
                    ]
                    path = urllib.parse.urlparse(self.path).path
                    if path in ("/v1/models", "/v1/models/"):
                        self._json(200, {"object": "list", "data": models})
                    else:
                        wanted = path.rsplit("/", 1)[-1]
                        match = [m for m in models if m["id"] == wanted]
                        if match:
                            self._json(200, match[0])
                        else:
                            self._oa_error(404,
                                           f"model {wanted!r} not found")
                elif self.path.startswith("/metrics"):
                    q = urllib.parse.urlparse(self.path).query
                    accept = self.headers.get("Accept", "")
                    if ("format=prometheus" in q
                            or "text/plain" in accept
                            or "openmetrics" in accept):
                        body = server.metrics.prometheus().encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self._cors()
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json(200, server.metrics.snapshot())
                else:
                    self._json(404, {"error": "not found"})

            def _read_audio(self) -> np.ndarray:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                if self.headers.get("X-Raw-Audio") == "1":
                    return np.frombuffer(raw, dtype=np.float32)
                # full width dispatch (8/16/24/32-bit PCM) + mixdown +
                # resample; unsupported formats raise -> 400 in do_POST
                from .utils.audio_io import decode_wav_bytes

                return decode_wav_bytes(raw)

            def _do_stream(self, qs) -> None:
                """Incremental transcription over HTTP: audio in (chunked
                transfer-encoding or plain body, raw float32 PCM @16k or
                WAV), confirmed-text NDJSON lines out as a chunked response.

                One StreamingTranscriber per request (bf16 cross-KV and
                cache, as in JAX); its decodes run in this handler thread,
                beside the batch worker's. Suits a few
                concurrent live streams; for many, use
                stream.MultiStreamTranscriber behind a gateway."""
                if qs.get("task", "transcribe") not in ("transcribe",
                                                        "translate"):
                    self._json(400, {"error": f"unknown task "
                                              f"{qs.get('task')!r}"})
                    return
                try:
                    kw = dict(language=qs.get("language", "en"),
                              task=qs.get("task", "transcribe"),
                              vad_gate=qs.get("vad") in ("1", "true"),
                              decode_interval=float(
                                  qs.get("decode_interval", "1.0")),
                              spec_k=int(server.default_options.get("spec_k", 4)))
                except ValueError as e:
                    self._json(400, {"error": f"bad stream option: {e}"})
                    return
                sid = next(_stream_ids)
                try:
                    server._call("stream_open", sid, kw)
                except Exception as e:
                    self._json(500, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self._cors()
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def emit(obj) -> None:
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                def feed(piece) -> None:
                    for ev in server._call("stream_feed", sid, piece):
                        emit({"text": ev.text, "final": False})

                te = (self.headers.get("Transfer-Encoding") or "").lower()
                try:
                    if "chunked" in te:
                        pending = b""
                        while True:
                            line = self.rfile.readline().strip()
                            # chunk-size may carry extensions: "4;name=val"
                            size_tok = line.split(b";", 1)[0].strip()
                            n = int(size_tok or b"0", 16)
                            if n == 0:
                                # consume optional trailer fields up to the
                                # terminating blank line
                                while True:
                                    t = self.rfile.readline()
                                    if t in (b"\r\n", b"\n", b""):
                                        break
                                break
                            pending += self.rfile.read(n)
                            self.rfile.read(2)  # CRLF
                            usable = (len(pending) // 4) * 4
                            if usable:
                                piece = np.frombuffer(pending[:usable],
                                                      np.float32)
                                pending = pending[usable:]
                                feed(piece)
                    else:
                        audio = self._read_audio()  # raw-PCM or WAV body
                        sr = 16_000
                        for off in range(0, len(audio), sr):
                            feed(audio[off : off + sr])
                    for ev in server._call("stream_finish", sid):
                        emit({"text": ev.text, "final": True})
                except Exception as e:  # surface in-band; stream stays valid
                    emit({"error": str(e), "final": True})
                finally:
                    server._close_stream(sid)
                self.wfile.write(b"0\r\n\r\n")

            # -- OpenAI-compatible audio API ------------------------------

            def _oa_error(self, code: int, message: str) -> None:
                self._json(code, {"error": {
                    "message": message, "type": "invalid_request_error"}})

            def _parse_multipart(self):
                """Returns (fields: dict[str, list[str]], file_bytes,
                filename) from a multipart/form-data body."""
                from email import policy
                from email.parser import BytesParser

                ctype = self.headers.get("Content-Type", "")
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                msg = BytesParser(policy=policy.default).parsebytes(
                    b"Content-Type: " + ctype.encode("latin-1")
                    + b"\r\nMIME-Version: 1.0\r\n\r\n" + body)
                if not msg.is_multipart():
                    raise ValueError("multipart/form-data body required")
                fields: Dict[str, list] = {}
                file_bytes, filename = None, ""
                for part in msg.iter_parts():
                    name = part.get_param(
                        "name", header="content-disposition")
                    if name == "file":
                        file_bytes = part.get_payload(decode=True)
                        filename = part.get_filename() or ""
                    elif name:
                        raw = part.get_payload(decode=True) or b""
                        fields.setdefault(name, []).append(
                            raw.decode("utf-8"))
                return fields, file_bytes, filename

            def _decode_upload(self, data: bytes,
                               filename: str) -> np.ndarray:
                """WAV directly from bytes; FLAC via the native decoder
                (path-based API) through a temp file."""
                if data[:4] == b"fLaC" or filename.lower().endswith(".flac"):
                    import os
                    import tempfile

                    from .utils.audio_io import load_audio

                    fd, path = tempfile.mkstemp(suffix=".flac")
                    try:
                        with os.fdopen(fd, "wb") as f:
                            f.write(data)
                        return load_audio(path)
                    finally:
                        os.unlink(path)
                from .utils.audio_io import decode_wav_bytes

                return decode_wav_bytes(data)

            def _do_openai_audio(self, task: str) -> None:
                try:
                    fields, file_bytes, filename = self._parse_multipart()
                except Exception as e:
                    self._oa_error(400, f"could not parse form: {e}")
                    return
                if file_bytes is None:
                    self._oa_error(400, "'file' form field is required")
                    return
                try:
                    audio = self._decode_upload(file_bytes, filename)
                except Exception as e:
                    self._oa_error(400, f"could not decode audio: {e}")
                    return

                def first(key, default=None):
                    return fields.get(key, [default])[0]

                response_format = first("response_format", "json")
                if response_format not in ("json", "text", "srt",
                                           "verbose_json", "vtt"):
                    self._oa_error(
                        400, f"unknown response_format {response_format!r}")
                    return
                grans = (fields.get("timestamp_granularities[]", [])
                         + fields.get("timestamp_granularities", []))
                if "word" in grans and response_format != "verbose_json":
                    # OpenAI semantics — and the alignment pass is real
                    # device work whose output only verbose_json serialises
                    self._oa_error(400, "timestamp_granularities[]=word "
                                        "requires response_format="
                                        "verbose_json")
                    return
                options: Dict[str, Any] = {"task": task}
                if first("language"):
                    options["language"] = first("language")
                if first("prompt"):
                    # per-row first-window conditioning; both schedulers
                    # support it (CB: per-row pads in serve_cb.CBState)
                    options["initial_prompt"] = first("prompt")
                if first("temperature") is not None:
                    try:
                        options["temperature"] = float(first("temperature"))
                    except ValueError:
                        self._oa_error(400, "temperature must be a number")
                        return
                if "word" in grans:
                    options["word_timestamps"] = True
                try:
                    server.batch_options(options)
                except (ValueError, TypeError) as e:
                    self._oa_error(400, f"bad option: {e}")
                    return

                server.metrics.inc("openai_requests_total")
                job = server.submit(audio, options)
                if job.error:
                    self._json(500, {"error": {"message": job.error,
                                               "type": "server_error"}})
                    return
                result = job.result
                if response_format == "text":
                    body = (result["text"].strip() + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self._cors()
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif response_format in ("srt", "vtt"):
                    import io

                    from .utils.writers import write_srt, write_vtt

                    buf = io.StringIO()
                    (write_srt if response_format == "srt"
                     else write_vtt)(result, buf)
                    body = buf.getvalue().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self._cors()
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif response_format == "verbose_json":
                    out = {
                        "task": task,
                        "language": result.get("language"),
                        "duration": round(len(audio) / 16_000.0, 3),
                        "text": result["text"],
                        "segments": result["segments"],
                    }
                    if "word" in grans:
                        out["words"] = [
                            w for s in result["segments"]
                            for w in s.get("words", [])]
                    self._json(200, out)
                else:  # json
                    self._json(200, {"text": result["text"]})

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                qs = {k: v[0] for k, v in
                      urllib.parse.parse_qs(parsed.query).items()}
                try:
                    n_body = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    self.close_connection = True
                    self._json(400, {"error": "malformed Content-Length"})
                    return
                if n_body > server.max_body_bytes:
                    # drain nothing; close after responding (the client is
                    # mid-upload of a too-large body)
                    self.close_connection = True
                    self._json(413, {"error": f"body {n_body} bytes exceeds "
                                              f"limit {server.max_body_bytes}"})
                    return
                if parsed.path == "/v1/audio/transcriptions":
                    self._do_openai_audio("transcribe")
                    return
                if parsed.path == "/v1/audio/translations":
                    self._do_openai_audio("translate")
                    return
                if parsed.path == "/stream":
                    server.metrics.inc("streams_total")
                    self._do_stream(qs)
                    return
                if parsed.path not in ("/transcribe", "/detect"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    audio = self._read_audio()
                except Exception as e:
                    self._json(400, {"error": f"bad audio: {e}"})
                    return

                if parsed.path == "/detect":
                    server.metrics.inc("detects_total")
                    try:
                        code, probs = server._call("detect", audio)
                        top = dict(sorted(probs.items(),
                                          key=lambda kv: -kv[1])[:5])
                        self._json(200, {"language": code, "probs": top})
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                    return

                try:
                    options = _query_options(qs)
                    server.batch_options(options)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad option: {e}"})
                    return
                job = server.submit(audio, options)
                if job.error:
                    self._json(500, {"error": job.error})
                else:
                    self._json(200, job.result)

        return Handler

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._worker.start()
        if self._mesh:
            threading.Thread(target=self._heartbeat, daemon=True).start()
        if self._do_warmup:
            threading.Thread(target=self._warmup, daemon=True).start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket
        # unblock any queued-but-undrained jobs: their submit() callers
        # would otherwise sit out the full request timeout
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            job.error = "server shutting down"
            job.done.set()
        if self._mesh:
            # after the command in flight, if any: the followers return
            self._release()


def _query_options(qs: Dict[str, str]) -> Dict[str, Any]:
    """/transcribe's query string as ServeOptions fields; raises
    ValueError on a value that does not parse."""
    options: Dict[str, Any] = {}
    if "task" in qs:
        options["task"] = qs["task"]
    if "language" in qs:
        options["language"] = qs["language"]
    if "beam_size" in qs:
        options["beam_size"] = int(qs["beam_size"])
    if "sample_len" in qs:
        options["sample_len"] = int(qs["sample_len"])
    if qs.get("without_timestamps") in ("1", "true"):
        options["without_timestamps"] = True
    if qs.get("word_timestamps") in ("1", "true"):
        options["word_timestamps"] = True
    if qs.get("vad") in ("1", "true"):
        options["vad_filter"] = True
    for name in ("no_speech_threshold", "logprob_threshold",
                 "compression_ratio_threshold"):
        if name in qs:
            options[name] = None if qs[name] == "none" else float(qs[name])
    if "temperature" in qs:
        options["temperature"] = tuple(
            float(t) for t in qs["temperature"].split(","))
    return options


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Whisper HTTP server (PyTorch/CUDA)")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="TP degree under torchrun: a (ranks / N, N) mesh; "
                         "rank 0 serves, the other ranks follow its commands")
    ap.add_argument("--quantize", choices=("int8",), default=None,
                    help="weights-only int8 serving")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="cross-attention K/V precision")
    ap.add_argument("--allow-origin", default=None, metavar="ORIGIN",
                    help="enable CORS for this origin ('*' for any); off "
                         "by default — the server has no auth")
    ap.add_argument("--scheduler", choices=("static", "continuous"),
                    default="static",
                    help="continuous: per-row positions + mid-flight slot "
                         "refill (serve_cb) — wins on mixed-length traffic")
    ap.add_argument("--warmup", action="store_true",
                    help="run one batch at startup; /readyz returns 503 "
                         "until done")
    ap.add_argument("--sample-len", type=int, default=None, metavar="N",
                    help="decode at most N tokens a window (ServeOptions."
                         "sample_len; default: half the text context)")
    ap.add_argument("--draft-model", default=None, metavar="NAME",
                    help="paired draft for speculative decoding on the static "
                         "scheduler's greedy and sampled rungs (e.g. "
                         "large-v3-turbo for large-v3; must share the "
                         "tokenizer)")
    ap.add_argument("--draft-checkpoint", default=None,
                    help="converted checkpoint for --draft-model")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft proposals per speculative verify step")
    args = ap.parse_args(argv)

    from . import load_model

    import torch.distributed as dist

    mesh, joined = None, dist.is_initialized()
    if args.tensor_parallel > 1:
        from .parallel.mesh import launch_mesh

        mesh = launch_mesh(args.tensor_parallel, "--tensor-parallel",
                           "openai_whisper_coreml_tpu_torch.serve_http")
    on_mesh = {} if mesh is None else {"mesh": mesh}
    model = load_model(args.model, checkpoint=args.checkpoint,
                       quantize=args.quantize, **on_mesh)
    if args.draft_model:
        from .speculative import check_pair

        draft = load_model(args.draft_model, checkpoint=args.draft_checkpoint,
                           quantize=args.quantize, **on_mesh)
        check_pair(model.cfg, draft.cfg)
        model.draft = draft
    if mesh is None:
        return _serve(model, args)
    try:
        if dist.get_rank() != 0:
            follow(model)
            return 0
        return _serve(model, args)
    finally:
        if not joined:
            dist.destroy_process_group()


def _serve(model, args) -> int:
    """Rank 0's (or the only process's) server, until SIGINT or SIGTERM."""
    import signal

    defaults = {"kv_dtype": args.kv_dtype, "scheduler": args.scheduler,
                "spec_k": args.spec_k}
    if args.sample_len is not None:
        defaults["sample_len"] = args.sample_len
    server = WhisperHTTPServer(model, args.host, args.port,
                               batch_size=args.batch_size,
                               allow_origin=args.allow_origin,
                               warmup=args.warmup, default_options=defaults)
    server.start()
    print(f"serving {args.model} on {args.host}:{server.port} "
          f"({model.device})", flush=True)

    def interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, interrupt)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
