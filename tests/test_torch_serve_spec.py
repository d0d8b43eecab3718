"""Port speculative decoding through the serving surface (`model.draft`)
against JAX's serving with the same weights (`params.from_jax_params`).

Under the static scheduler a paired draft gives JAX's segments (greedy
rungs are exact by construction); sampled rungs keep the draft and stay
deterministic per seed; beam and the continuous schedulers keep the plain
loop, as JAX's do; every speculative decode adds to speculative.TOTALS,
and the HTTP server's /metrics carries the speculative counters and the
governor's gauges."""

import copy
import dataclasses
import io
import json
import os
import sys
import tempfile
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.serve import ServeOptions as JaxServeOptions
from openai_whisper_coreml_tpu.serve import transcribe_batch as jax_transcribe_batch
from openai_whisper_coreml_tpu_torch import ServeOptions, speculative, transcribe_batch
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

KW = dict(n_state=64, n_head=2, n_layer=2)


def _pair(key):
    params = jax_init(jax_tiny(**KW), jax.random.PRNGKey(key))
    return (JaxModel(cfg=jax_tiny(**KW), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**KW)))


@pytest.fixture(scope="module")
def models():
    return _pair(0)


@pytest.fixture(scope="module")
def drafts():
    """Same token space, independent weights: the acceptance floor, where
    every verify step still commits at least one exact target token."""
    return _pair(7)


def _with_draft(model, draft):
    paired = copy.copy(model)
    paired.draft = draft
    return paired


def _audios(seconds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(seconds):
        t = np.arange(int(s * 16_000)) / 16_000
        out.append((0.2 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                    + 0.02 * rng.standard_normal(t.shape)).astype(np.float32))
    return out


def _toks(results):
    return [[t for seg in r["segments"] for t in seg["tokens"]] for r in results]


def _key(results):
    return [[(s["seek"], s["start"], s["end"], s["tokens"], s["text"])
             for s in r["segments"]] for r in results]


QUIET = dict(no_speech_threshold=None, logprob_threshold=None,
             compression_ratio_threshold=None)


def test_static_greedy_with_draft_matches_plain(models, drafts):
    """The floor draft under the static scheduler: the port's segments are
    its plain segments and JAX's with the same draft."""
    jm, tm = models
    jd, td = drafts
    audios = _audios([0.9, 1.2])
    kw = dict(scheduler="static", batch_size=2, language="en", temperature=(0.0,),
              sample_len=12, spec_k=3, **QUIET)
    plain = transcribe_batch(tm, audios, ServeOptions(**kw))
    before = dict(speculative.TOTALS)
    ours = transcribe_batch(_with_draft(tm, td), audios, ServeOptions(**kw))
    assert speculative.TOTALS["iters"] > before["iters"]
    ref = jax_transcribe_batch(dataclasses.replace(jm, draft=jd), audios,
                               JaxServeOptions(**kw))
    assert _key(ours) == _key(plain) == _key(ref)
    assert [r["text"] for r in ours] == [r["text"] for r in ref]
    for o, r in zip(ours, ref):
        for so, sr in zip(o["segments"], r["segments"]):
            assert so["avg_logprob"] == pytest.approx(sr["avg_logprob"], abs=1e-4)


def test_draft_rides_sampled_rungs_but_not_cb(models, drafts):
    """t > 0 rungs keep the draft through rejection sampling (exact in
    distribution, pinned in test_torch_speculative.py): it runs, and
    serving stays deterministic per seed. The continuous scheduler and a
    beam rung keep the plain loop."""
    _, tm = models
    _, td = drafts
    audios = _audios([1.0])
    spec_model = _with_draft(tm, td)
    opts = ServeOptions(scheduler="static", batch_size=1, language="en",
                        temperature=(0.7,), sample_len=8, spec_fallback=False,
                        **QUIET)
    before = dict(speculative.TOTALS)
    b1 = transcribe_batch(spec_model, audios, opts)
    assert speculative.TOTALS["iters"] > before["iters"]
    b2 = transcribe_batch(spec_model, audios, opts)
    assert _toks(b1) == _toks(b2)
    for cb in (dataclasses.replace(opts, scheduler="continuous", temperature=(0.0,)),
               dataclasses.replace(opts, temperature=(0.0,), beam_size=2)):
        c = transcribe_batch(tm, audios, cb)
        mid = dict(speculative.TOTALS)
        d = transcribe_batch(spec_model, audios, cb)
        assert speculative.TOTALS == mid
        assert _toks(c) == _toks(d)


def test_spec_stats_accumulate(models, drafts):
    """Every speculative decode adds to speculative.TOTALS (the server diffs
    it around each batch for its /metrics gauges)."""
    _, tm = models
    _, td = drafts
    opts = ServeOptions(scheduler="static", batch_size=1, language="en",
                        temperature=(0.0,), sample_len=10, spec_k=3, **QUIET)
    before = dict(speculative.TOTALS)
    transcribe_batch(_with_draft(tm, td), _audios([0.8]), opts)
    after = speculative.TOTALS
    assert after["iters"] > before["iters"]
    assert after["tokens"] >= before["tokens"] + after["iters"] - before["iters"]
    assert after["drafted"] == before["drafted"] + 3 * (after["iters"]
                                                        - before["iters"])
    assert speculative.LAST_STATS is not None
    assert 0.0 <= speculative.LAST_STATS["acceptance_rate"] <= 1.0


def test_server_metrics_carry_the_speculative_counters(models):
    """A server whose model carries a draft: a batch's speculative tokens
    and iterations become counters, its tokens per iteration and acceptance
    gauges, and the governor's verdict and threshold gauges (JAX's
    serve_http names)."""
    from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    _, tm = models
    srv = WhisperHTTPServer(_with_draft(tm, tm), port=0, batch_size=2,
                            batch_window_ms=20,
                            default_options={"language": "en", "sample_len": 12,
                                             "temperature": (0.0,), "spec_k": 3,
                                             **QUIET})
    srv.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "a.wav")
            save_wav(path, _audios([1.5])[0])
            with open(path, "rb") as f:
                body = f.read()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/transcribe",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and json.loads(r.read())["segments"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics?format=prometheus",
                timeout=60) as r:
            prom = io.TextIOWrapper(r).read()
    finally:
        srv.stop()
    counters, gauges = metrics["counters"], metrics["gauges"]
    assert counters["spec_iters"] > 0
    assert counters["spec_tokens"] >= counters["spec_iters"]
    assert gauges["spec_tokens_per_iter"] == pytest.approx(
        counters["spec_tokens"] / counters["spec_iters"])
    assert 0.0 <= gauges["spec_acceptance_rate"] <= 1.0
    assert gauges["spec_draft_active"] == 1.0
    assert gauges["spec_draft_active_sampled"] == 1.0
    assert gauges["spec_governor_threshold"] > 1.0
    assert gauges["spec_governor_calibrated"] in (0.0, 1.0)
    assert "spec_acceptance_rate" in prom


def test_totals_take_concurrent_decodes_whole():
    """The server's batch worker and its /stream handlers decode in
    threads of one process, so accumulate_stats updates speculative.TOTALS
    under a lock: concurrent updates lose nothing."""
    import os
    import sys
    import threading

    before = dict(speculative.TOTALS)
    n_threads, n_calls = 4 * (os.cpu_count() or 2), 300
    stats = {"iters": 1, "tokens": 2, "drafted": 3}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [speculative.accumulate_stats(stats)
                                                    for _ in range(n_calls)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * n_calls
    assert {k: speculative.TOTALS[k] - before[k] for k in before} == {
        "iters": n, "tokens": 2 * n, "drafted": 3 * n}
