"""Port the acceptance governor (`speculative.SpecGovernor` and its wiring in
serve.py, transcribe.py and stream.py) against JAX's tests.

The governor's logic is held to JAX's own figures: every test here runs
with JAX's `_KINETICS` table patched into the port's module, while the
table the port ships holds its H100 priors (`tools/torch_spec_time.py`).
The unit tests are JAX's, on the port's class. The wiring tests run JAX's
serving, streaming and transcribe scenarios on the port with the JAX
weights (`params.from_jax_params`): a draft at the acceptance floor is
withheld after enough evidence, an agreeing draft is kept, the knobs reach
the governor, and transcripts equal the plain path's throughout."""

import copy

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import speculative as jax_spec
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import ServeOptions, transcribe_batch
from openai_whisper_coreml_tpu_torch import speculative
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.serve import spec_governor
from openai_whisper_coreml_tpu_torch.speculative import (
    SpecGovernor,
    break_even_tokens_per_iter,
)

torch.set_num_threads(1)


# the table the port ships, before any test patches JAX's in
SHIPPED = dict(speculative._KINETICS)


@pytest.fixture(autouse=True)
def jax_kinetics(monkeypatch):
    monkeypatch.setattr(speculative, "_KINETICS", dict(jax_spec._KINETICS))


def test_shipped_prior_is_the_h100_table(monkeypatch):
    """The port ships its own table, not JAX's: at every geometry the
    break-even lies above one token per iteration and rises with K."""
    assert SHIPPED != jax_spec._KINETICS
    assert sorted(SHIPPED) == sorted(jax_spec._KINETICS)
    monkeypatch.setattr(speculative, "_KINETICS", SHIPPED)
    for b in SHIPPED:
        vals = [break_even_tokens_per_iter(k, batch=b) for k in (1, 4, 8, 16)]
        assert vals[0] > 1.0 and all(y > x for x, y in zip(vals, vals[1:]))


# -- unit: the governor itself (JAX's tests) ------------------------------------


def test_break_even_model():
    # JAX's table: K=4 -> 29.06 ms/iter against 8.95 ms/token at B24
    assert break_even_tokens_per_iter(4) == pytest.approx(3.25, abs=0.02)
    assert break_even_tokens_per_iter(8) == pytest.approx(4.21, abs=0.02)
    assert break_even_tokens_per_iter(4, batch=1) == pytest.approx(3.70, abs=0.02)
    assert break_even_tokens_per_iter(8, batch=1) == pytest.approx(4.41, abs=0.02)
    assert break_even_tokens_per_iter(4, batch=8) == pytest.approx(2.90, abs=0.02)
    assert break_even_tokens_per_iter(4, batch=16) == pytest.approx(3.48, abs=0.02)
    assert break_even_tokens_per_iter(4, batch=32) == pytest.approx(3.42, abs=0.02)
    assert (break_even_tokens_per_iter(4, batch=1)
            > break_even_tokens_per_iter(4, batch=24)
            > break_even_tokens_per_iter(4, batch=8))
    # nearest in log batch: 4 -> the B8 entry, 48 -> the B32 entry
    assert (break_even_tokens_per_iter(4, batch=4)
            == break_even_tokens_per_iter(4, batch=8))
    assert (break_even_tokens_per_iter(4, batch=48)
            == break_even_tokens_per_iter(4, batch=32))
    for b in (1, 8, 16, 24, 32):
        vals = [break_even_tokens_per_iter(k, batch=b) for k in (1, 2, 4, 8, 16)]
        assert all(y > x for x, y in zip(vals, vals[1:]))
        assert vals[0] > 1.0


def test_governor_threshold_validation():
    with pytest.raises(ValueError, match="threshold"):
        SpecGovernor(threshold=1.0)


def test_governor_disables_below_threshold_and_reprobes():
    gov = SpecGovernor(threshold=3.0, min_iters=32, window=8, reprobe_every=4)
    assert gov.permit()  # no evidence yet: the draft runs
    gov.observe({"tokens": 20, "iters": 20})  # tpi 1.0, not enough mass
    assert not gov.disabled
    gov.observe({"tokens": 20, "iters": 20})  # 40 iters >= 32: a verdict
    assert gov.disabled
    permits = [gov.permit() for _ in range(8)]
    assert permits == [False, False, False, True, False, False, False, True]


def test_governor_reenables_on_recovery():
    gov = SpecGovernor(threshold=3.0, min_iters=16, window=8, reprobe_every=2)
    gov.observe({"tokens": 16, "iters": 16})
    assert gov.disabled
    # the disable cleared the damning window: recovery needs fresh mass
    gov.observe({"tokens": 32, "iters": 8})
    assert gov.disabled
    gov.observe({"tokens": 32, "iters": 8})
    assert not gov.disabled
    assert gov.permit()


def test_governor_ignores_non_spec_decodes():
    gov = SpecGovernor(threshold=3.0, min_iters=1)
    gov.observe(None)
    gov.observe({"tokens": 0, "iters": 0})
    assert gov.tokens_per_iter is None
    assert not gov.disabled


def test_governor_live_calibration():
    gov = SpecGovernor(threshold=3.0, calib_min_obs=3)
    assert gov.threshold == 3.0 and not gov.calibrated
    for _ in range(3):  # 24 ms/iter
        gov.observe_timing({"path": "spec", "wall_s": 0.24, "units": 10})
    assert not gov.calibrated  # needs both terms
    assert gov.live_iter_ms == pytest.approx(24.0)
    for _ in range(3):  # 12 ms/token
        gov.observe_timing({"path": "plain", "wall_s": 0.12, "units": 10})
    assert gov.calibrated
    assert gov.live_tok_ms == pytest.approx(12.0)
    assert gov.threshold == pytest.approx(2.0)


def test_governor_calibration_buckets_by_geometry():
    """Plain walls at another batch never enter the live ratio."""
    gov = SpecGovernor(threshold=3.0, calib_min_obs=3)
    for _ in range(3):
        gov.observe_timing({"path": "spec", "wall_s": 0.29, "units": 10,
                            "batch": 24, "k": 4, "temperature": 0.0})
    for _ in range(3):
        gov.observe_timing({"path": "plain", "wall_s": 0.0227, "units": 10,
                            "batch": 1, "temperature": 0.0})
    assert not gov.calibrated
    assert gov.threshold == pytest.approx(3.0)
    for _ in range(3):
        gov.observe_timing({"path": "plain", "wall_s": 0.0895, "units": 10,
                            "batch": 24, "temperature": 0.0})
    assert gov.calibrated
    assert gov.threshold == pytest.approx(0.29 * 1e3 / 10 / 8.95)


def test_governor_regimes_are_independent():
    gov = SpecGovernor(threshold=3.0, min_iters=16, window=8, reprobe_every=4)
    gov.observe({"tokens": 64, "iters": 16}, sampled=False)  # tpi 4.0
    assert not gov.disabled
    gov.observe({"tokens": 17, "iters": 16}, sampled=True)  # tpi ~1.06
    assert gov.disabled_sampled
    assert not gov.disabled
    assert gov.permit(sampled=False)
    assert not gov.permit(sampled=True)
    permits = [gov.permit(sampled=True) for _ in range(4)]
    assert permits == [False, False, True, False]


def test_governor_calibration_median_kills_compile_wall():
    """A first wall that builds kernels is outvoted by the median."""
    gov = SpecGovernor(threshold=3.0, calib_min_obs=3)
    gov.observe_timing({"path": "spec", "wall_s": 30.0, "units": 10})
    for _ in range(4):
        gov.observe_timing({"path": "spec", "wall_s": 0.24, "units": 10})
    assert gov.live_iter_ms == pytest.approx(24.0)


def test_governor_live_threshold_drives_verdict():
    gov = SpecGovernor(threshold=3.5, min_iters=16, calib_min_obs=3)
    for _ in range(3):
        gov.observe_timing({"path": "spec", "wall_s": 0.24, "units": 10})
        gov.observe_timing({"path": "plain", "wall_s": 0.12, "units": 10})
    assert gov.threshold == pytest.approx(2.0)
    gov.observe({"tokens": 50, "iters": 20})  # tpi 2.5: > live, < prior
    assert not gov.disabled
    gov.observe({"tokens": 20, "iters": 20})  # window tpi 1.75 < live 2.0
    assert gov.disabled


def test_governor_pinned_threshold_ignores_calibration():
    gov = SpecGovernor(threshold=1.5, pinned=True)
    for _ in range(5):
        gov.observe_timing({"path": "spec", "wall_s": 0.24, "units": 10})
        gov.observe_timing({"path": "plain", "wall_s": 0.12, "units": 10})
    assert not gov.calibrated
    assert gov.live_iter_ms is None and gov.live_tok_ms is None
    assert gov.threshold == pytest.approx(1.5)


def test_governor_timing_none_safe():
    gov = SpecGovernor(threshold=3.0)
    gov.observe_timing(None)
    gov.observe_timing({"path": "plain", "wall_s": 0.1, "units": 0})
    gov.observe_timing({"path": "beam", "wall_s": 0.1, "units": 10})
    assert gov.live_iter_ms is None and gov.live_tok_ms is None


def test_governor_calibration_window_slides():
    gov = SpecGovernor(threshold=3.0, calib_window=4)
    for _ in range(4):
        gov.observe_timing({"path": "spec", "wall_s": 0.40, "units": 10})
    for _ in range(4):
        gov.observe_timing({"path": "spec", "wall_s": 0.20, "units": 10})
    assert gov.live_iter_ms == pytest.approx(20.0)


def test_governor_window_slides():
    gov = SpecGovernor(threshold=3.0, min_iters=4, window=2, reprobe_every=2)
    gov.observe({"tokens": 40, "iters": 10})
    assert not gov.disabled
    gov.observe({"tokens": 10, "iters": 10})
    gov.observe({"tokens": 10, "iters": 10})
    assert gov.disabled


def test_governed_decode_observes_its_own_thread():
    """The server's batch worker and its /stream handlers decode on one
    model at once: a decode that another thread finishes while this one
    runs reaches LAST_STATS and TOTALS but not this governor, which reads
    this thread's acceptance and wall."""
    import threading

    gov = SpecGovernor(threshold=1.5, min_iters=4, calib_min_obs=1)
    before = dict(speculative.TOTALS)
    mine = {"tokens": 40, "iters": 10, "drafted": 30}
    other = {"tokens": 10, "iters": 10, "drafted": 30}

    def decode_fn(draft):
        assert draft == "draft"
        speculative.publish(mine, {"path": "spec", "wall_s": 0.5, "units": 10})
        stream = threading.Thread(target=speculative.publish, args=(
            other, {"path": "spec", "wall_s": 3.0, "units": 10}))
        stream.start()
        stream.join()
        return "tokens"

    assert speculative.governed_decode(gov, "draft", decode_fn) == "tokens"
    assert speculative.LAST_STATS is other  # module-wide: the latest decode
    assert speculative.LAST_TIMING["wall_s"] == 3.0
    assert {k: speculative.TOTALS[k] - before[k] for k in before} == {
        "iters": 20, "tokens": 50, "drafted": 60}
    assert gov.tokens_per_iter == pytest.approx(4.0) and not gov.disabled
    assert gov.live_iter_ms == pytest.approx(50.0)


# -- integration: the serving ladder, transcribe and streams -------------------


def _port(key):
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(key))
    return from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw))


@pytest.fixture(scope="module")
def model():
    return _port(0)


@pytest.fixture(scope="module")
def floor_draft():
    """Same token space, independent weights: the acceptance floor."""
    return _port(7)


def _with_draft(model, draft):
    """The model with a paired draft, as JAX's dataclasses.replace(model,
    draft=...): a shallow copy, with a governor of its own."""
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


_OPTS = dict(scheduler="static", language="en", temperature=(0.0,), spec_k=3,
             no_speech_threshold=None, logprob_threshold=None,
             compression_ratio_threshold=None)


def test_serving_governor_withholds_floor_draft(model, floor_draft):
    """The first batch gathers the evidence, later batches run plain, a
    probe batch runs the draft again, and transcripts stay the plain ones."""
    spec_model = _with_draft(model, floor_draft)
    audios = _audios([0.9, 1.2])
    opts = ServeOptions(batch_size=2, sample_len=20, **_OPTS)
    plain = transcribe_batch(model, audios, opts)

    before = dict(speculative.TOTALS)
    first = transcribe_batch(spec_model, audios, opts)
    gov = spec_governor(spec_model, opts)
    assert speculative.TOTALS["iters"] > before["iters"]
    assert gov.disabled

    mid = dict(speculative.TOTALS)
    second = transcribe_batch(spec_model, audios, opts)
    assert speculative.TOTALS["iters"] == mid["iters"]  # withheld
    assert _toks(plain) == _toks(first) == _toks(second)

    gov._skips[False] = gov.reprobe_every - 1
    third = transcribe_batch(spec_model, audios, opts)
    assert speculative.TOTALS["iters"] > mid["iters"]  # the probe batch
    assert _toks(third) == _toks(plain)
    assert getattr(model, "_spec_governor", None) is None


def test_serving_governor_calibration_feeds(model, floor_draft):
    """Speculative batches feed ms per iteration, withheld ones ms per
    token: the two terms of the live break-even."""
    spec_model = _with_draft(model, floor_draft)
    audios = _audios([0.9, 1.2])
    opts = ServeOptions(batch_size=2, sample_len=20, **_OPTS)
    transcribe_batch(spec_model, audios, opts)
    gov = spec_governor(spec_model, opts)
    assert gov.live_iter_ms is not None and gov.live_iter_ms > 0
    assert gov.disabled
    transcribe_batch(spec_model, audios, opts)
    assert gov.live_tok_ms is not None and gov.live_tok_ms > 0


def test_serving_governor_keeps_agreeing_draft(model):
    """Draft == target: every proposal matches (K+1 tokens per iteration,
    above break-even), so the governor never withholds it."""
    spec_model = _with_draft(model, model)
    audios = _audios([0.9, 1.2])
    opts = ServeOptions(batch_size=2, sample_len=20, **_OPTS)
    before = dict(speculative.TOTALS)
    transcribe_batch(spec_model, audios, opts)
    mid = dict(speculative.TOTALS)
    assert mid["iters"] > before["iters"]
    transcribe_batch(spec_model, audios, opts)
    assert speculative.TOTALS["iters"] > mid["iters"]
    gov = spec_governor(spec_model, opts)
    assert not gov.disabled
    assert gov.tokens_per_iter == pytest.approx(4.0)


def test_serving_spec_fallback_opt_out(model, floor_draft):
    """spec_fallback=False: the draft always runs, no governor attached."""
    spec_model = _with_draft(model, floor_draft)
    opts = ServeOptions(batch_size=1, sample_len=20, spec_fallback=False, **_OPTS)
    before = dict(speculative.TOTALS)
    transcribe_batch(spec_model, _audios([0.9]), opts)
    mid = dict(speculative.TOTALS)
    transcribe_batch(spec_model, _audios([0.9]), opts)
    assert speculative.TOTALS["iters"] > mid["iters"] > before["iters"]
    assert getattr(spec_model, "_spec_governor", None) is None


def test_serving_custom_threshold(model, floor_draft):
    """A spec_fallback_threshold below the floor's tokens per iteration
    keeps even the disagreeing draft: the knob reaches the governor."""
    spec_model = _with_draft(model, floor_draft)
    audios = _audios([0.9, 1.2])
    opts = ServeOptions(batch_size=2, sample_len=20, spec_fallback_threshold=1.01,
                        **_OPTS)
    transcribe_batch(spec_model, audios, opts)
    gov = spec_governor(spec_model, opts)
    assert gov.threshold == pytest.approx(1.01) and gov.pinned
    assert not gov.disabled
    mid = dict(speculative.TOTALS)
    transcribe_batch(spec_model, audios, opts)
    assert speculative.TOTALS["iters"] > mid["iters"]


def test_setting_the_draft_starts_a_fresh_governor(model, floor_draft):
    spec_model = _with_draft(model, floor_draft)
    opts = ServeOptions(batch_size=2, sample_len=20, **_OPTS)
    gov = spec_governor(spec_model, opts)
    assert spec_governor(spec_model, opts) is gov
    spec_model.draft = model
    assert spec_governor(spec_model, opts) is not gov


def test_streaming_governor_wiring(model, floor_draft):
    """StreamingTranscriber ticks feed the stream's governor: a floor draft
    is withheld after enough evidence, and the confirmed tokens are the
    plain stream's."""
    from openai_whisper_coreml_tpu_torch.stream import StreamingTranscriber

    audio = _audios([8.0])[0]

    def run(draft_model):
        st = StreamingTranscriber(model, language="en", agreement=1,
                                  decode_interval=2.0, sample_len=24,
                                  draft_model=draft_model, spec_k=3)
        toks = []
        for off in range(0, len(audio), 2 * 16000):
            for ev in st.feed(audio[off: off + 2 * 16000]):
                toks.extend(ev.tokens)
        for ev in st.finish():
            toks.extend(ev.tokens)
        return toks, st

    plain_toks, _ = run(None)
    before = dict(speculative.TOTALS)
    spec_toks, st = run(floor_draft)
    assert speculative.TOTALS["iters"] > before["iters"]
    assert st._spec_gov is not None and st._spec_gov.disabled
    assert spec_toks == plain_toks


def test_multistream_governor_wiring(model, floor_draft):
    """MultiStreamTranscriber's batched ticks carry the draft under one
    tier-level governor; a floor draft is withheld and the confirmations
    are the draft-less tier's."""
    from openai_whisper_coreml_tpu_torch.stream import MultiStreamTranscriber

    audio = _audios([8.0])[0]

    def run(draft_model):
        mst = MultiStreamTranscriber(model, n_streams=2, language="en",
                                     agreement=1, decode_interval=2.0,
                                     sample_len=24, draft_model=draft_model,
                                     spec_k=3)
        confirmed = {0: [], 1: []}
        for off in range(0, len(audio), 2 * 16000):
            chunk = audio[off: off + 2 * 16000]
            mst.feed(0, chunk)
            mst.feed(1, chunk)
            for i, evs in mst.poll().items():
                for ev in evs:
                    confirmed[i].extend(ev.tokens)
        return confirmed, mst

    plain, _ = run(None)
    before = dict(speculative.TOTALS)
    spec, mst = run(floor_draft)
    assert speculative.TOTALS["iters"] > before["iters"]
    assert mst._spec_gov is not None and mst._spec_gov.disabled
    assert spec == plain


def test_transcribe_governor_wiring(model, floor_draft):
    """transcribe(draft_model=...) keeps one governor per call; transcripts
    are the plain path's whatever its verdict, and spec_fallback=False is
    taken out of the decode options (the draft then runs ungoverned)."""
    from openai_whisper_coreml_tpu_torch.transcribe import transcribe

    audio = _audios([0.9])[0]
    kw = dict(language="en", temperature=0.0, sample_len=16,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None, condition_on_previous_text=False)
    plain = transcribe(model, audio, **kw)
    before = dict(speculative.TOTALS)
    spec = transcribe(model, audio, draft_model=floor_draft, **kw)
    assert speculative.TOTALS["iters"] > before["iters"]
    p = [t for s in plain["segments"] for t in s["tokens"]]
    assert [t for s in spec["segments"] for t in s["tokens"]] == p
    mid = dict(speculative.TOTALS)
    spec2 = transcribe(model, audio, draft_model=floor_draft, spec_fallback=False,
                       **kw)
    assert speculative.TOTALS["iters"] > mid["iters"]
    assert [t for s in spec2["segments"] for t in s["tokens"]] == p
