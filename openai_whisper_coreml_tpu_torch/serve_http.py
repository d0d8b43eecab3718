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
each batch's read as differences of `speculative.TOTALS`. The server
does not run on a mesh yet (the batch functions do, `parallel/`): it
needs a front end on rank 0 that broadcasts each batch to the other
ranks, so `--tensor-parallel` above 1 raises NotImplementedError.
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
        flips to 200 when done."""
        from .parallel.mesh import refuse_on_mesh

        refuse_on_mesh(model, "WhisperHTTPServer")
        self.model = model
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

    # -- batching worker ----------------------------------------------------

    def _drain(self) -> None:
        from . import speculative
        from .serve import ServeOptions, transcribe_batch

        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
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
                    jobs.append(self._queue.get(timeout=remaining))
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
                opts = {**self.default_options, **json.loads(opts_key)}
                t0 = time.monotonic()
                audio_s = sum(len(j.audio) for j in group) / 16_000.0
                spec_before = dict(speculative.TOTALS)
                try:
                    results = transcribe_batch(
                        self.model, [j.audio for j in group],
                        ServeOptions(batch_size=self.batch_size, **opts))
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
        from .serve import ServeOptions, transcribe_batch

        t0 = time.monotonic()
        try:
            silence = [np.zeros(16_000, np.float32)] * self.batch_size
            transcribe_batch(self.model, silence,
                             ServeOptions(batch_size=self.batch_size,
                                          **self.default_options))
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
                from .stream import StreamingTranscriber

                if qs.get("task", "transcribe") not in ("transcribe",
                                                        "translate"):
                    self._json(400, {"error": f"unknown task "
                                              f"{qs.get('task')!r}"})
                    return
                st = StreamingTranscriber(
                    server.model, language=qs.get("language", "en"),
                    task=qs.get("task", "transcribe"),
                    vad_gate=qs.get("vad") in ("1", "true"),
                    decode_interval=float(qs.get("decode_interval", "1.0")),
                    # the server's paired draft speeds the tick decodes; the
                    # stream's own governor handles low acceptance
                    draft_model=getattr(server.model, "draft", None),
                    spec_k=int(server.default_options.get("spec_k", 4)))
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
                                for ev in st.feed(piece):
                                    emit({"text": ev.text, "final": False})
                    else:
                        audio = self._read_audio()  # raw-PCM or WAV body
                        sr = 16_000
                        for off in range(0, len(audio), sr):
                            for ev in st.feed(audio[off : off + sr]):
                                emit({"text": ev.text, "final": False})
                    for ev in st.finish():
                        emit({"text": ev.text, "final": True})
                except Exception as e:  # surface in-band; stream stays valid
                    emit({"error": str(e), "final": True})
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
                        from .audio import pad_or_trim
                        from .decoding import detect_language

                        # the mel stays a tensor on the model's device
                        mel = server.model.log_mel(pad_or_trim(audio))
                        codes, probs = detect_language(server.model, mel[None])
                        top = dict(sorted(probs[0].items(),
                                          key=lambda kv: -kv[1])[:5])
                        self._json(200, {"language": codes[0], "probs": top})
                    except Exception as e:
                        self._json(500, {"error": str(e)})
                    return

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
                if "no_speech_threshold" in qs:
                    v = qs["no_speech_threshold"]
                    options["no_speech_threshold"] = (None if v == "none"
                                                      else float(v))
                if "logprob_threshold" in qs:
                    v = qs["logprob_threshold"]
                    options["logprob_threshold"] = (None if v == "none"
                                                    else float(v))
                if "compression_ratio_threshold" in qs:
                    v = qs["compression_ratio_threshold"]
                    options["compression_ratio_threshold"] = (
                        None if v == "none" else float(v))
                if "temperature" in qs:
                    options["temperature"] = tuple(
                        float(t) for t in qs["temperature"].split(","))

                job = server.submit(audio, options)
                if job.error:
                    self._json(500, {"error": job.error})
                else:
                    self._json(200, job.result)

        return Handler

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._worker.start()
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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Whisper HTTP server (PyTorch/CUDA)")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="shard over N cards (not in the server yet; 1 only)")
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
    if args.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor-parallel > 1 in the HTTP server (parallel/) is not "
            "ported yet: it needs a front end on rank 0 that broadcasts each "
            "batch to the other ranks (ROADMAP.md, Queue 1)")

    from . import load_model

    model = load_model(args.model, checkpoint=args.checkpoint,
                       quantize=args.quantize)
    if args.draft_model:
        from .speculative import check_pair

        draft = load_model(args.draft_model, checkpoint=args.draft_checkpoint,
                           quantize=args.quantize)
        check_pair(model.cfg, draft.cfg)
        model.draft = draft
    server = WhisperHTTPServer(model, args.host, args.port,
                               batch_size=args.batch_size,
                               allow_origin=args.allow_origin,
                               warmup=args.warmup,
                               default_options={"kv_dtype": args.kv_dtype,
                                                "scheduler": args.scheduler,
                                                "spec_k": args.spec_k})
    server.start()
    print(f"serving {args.model} on {args.host}:{server.port} "
          f"({model.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
