"""Port word timestamps (`timing.py`) against the JAX package's.

Every case of JAX's `tests/test_timing.py` runs on both packages (median
filter, DTW, the splits and merges, the heads formats, heads from
checkpoint metadata, the boundary heuristics); the alignment pass is held
to JAX's at fp32 on the CPU with the same weights (`params.from_jax_params`)
and inputs from `np.random.default_rng(seed)`: the batched core's matrix
and probabilities within 1e-5, and `find_word_alignment` (full, partial,
0.14 s and 0.08 s windows) and `find_word_alignment_batch` with equal
times and probabilities within 1e-5. The long-form and serving paths with
word timestamps are in `test_torch_wordts.py`."""

import base64
import gzip
import importlib
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import timing as jtm
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.models.whisper import load_model as jax_load_model
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer as jax_tokenizer
from openai_whisper_coreml_tpu_torch import config as tconfig
from openai_whisper_coreml_tpu_torch import timing as ttm
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.whisper import load_model
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
from openai_whisper_coreml_tpu_torch.utils.checkpoint import save_params

jtr = importlib.import_module("openai_whisper_coreml_tpu.transcribe")
ttr = importlib.import_module("openai_whisper_coreml_tpu_torch.transcribe")

torch.set_num_threads(1)

# JAX's alignment tests: a 64-position audio context
SIZE = dict(n_state=64, n_head=2, n_layer=2, n_audio_ctx=64, n_text_ctx=96)


@pytest.fixture(scope="module")
def models():
    params = jax_init(jax_tiny(**SIZE), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**SIZE), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**SIZE)))


@pytest.fixture(scope="module")
def toks():
    return (jax_tokenizer(jax_tiny(**SIZE), language="en"),
            get_tokenizer(tiny_test_config(**SIZE), language="en"))


def _assert_timings_equal(ours, ref):
    assert [(w.word, w.tokens, w.start, w.end) for w in ours] == [
        (w.word, w.tokens, w.start, w.end) for w in ref]
    for o, r in zip(ours, ref):
        assert o.probability == pytest.approx(r.probability, abs=1e-5)


# --- host pieces ----------------------------------------------------------

@pytest.mark.parametrize("shape,width", [((1, 7), 3), ((3, 40), 7), ((2, 5, 64), 7),
                                         ((4, 7), 7), ((2, 5), 7)])
def test_median_filter_matches_jax(shape, width):
    """The host filter equals JAX's; the device filter equals the host one
    wherever the slice is wider than the filter (JAX's identity shortcut
    below that), and the spike of JAX's test is removed."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    if shape == (1, 7):
        x = np.array([[1.0, 100.0, 1.0, 1.0, 1.0, 100.0, 1.0]], np.float32)
    ours = ttm.median_filter(x, width)
    np.testing.assert_array_equal(ours, jtm.median_filter(x, width))
    assert ours.shape == x.shape
    if shape == (1, 7):
        assert ours[0, 1] == 1.0
    if shape[-1] > width:
        np.testing.assert_array_equal(
            ttm._median_filter_dev(torch.from_numpy(x), width).numpy(), ours)
        np.testing.assert_array_equal(
            ttm._median_filter_dev(torch.from_numpy(x), width).numpy(),
            np.asarray(jtm._median_filter_dev(jnp.asarray(x), width)))


def test_median_filter_dev_refuses_even_width():
    with pytest.raises(ValueError, match="odd"):
        ttm._median_filter_dev(torch.zeros(1, 10), 4)


@pytest.mark.parametrize("case", ["identity", "rectangular", "ties", "tall"])
def test_dtw_path_matches_jax(case):
    rng = np.random.default_rng(len(case))
    cost = {"identity": np.ones((8, 8)) - np.eye(8),
            "rectangular": rng.random((5, 40)),
            # integer costs: many equal sums, so the tie order decides
            "ties": rng.integers(0, 3, (6, 30)).astype(np.float32),
            "tall": rng.random((12, 9))}[case]
    ti, fi = ttm.dtw_path(cost)
    jti, jfi = jtm.dtw_path(cost)
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(fi, jfi)
    assert ti[0] == 0 and fi[0] == 0
    assert ti[-1] == cost.shape[0] - 1 and fi[-1] == cost.shape[1] - 1
    assert (np.diff(ti) >= 0).all() and (np.diff(fi) >= 0).all()
    assert sorted(set(ti)) == list(range(cost.shape[0]))


def test_default_alignment_heads():
    for n_layer, n_head in ((4, 2), (3, 4), (32, 20)):
        ours = ttm.default_alignment_heads(tiny_test_config(n_layer=n_layer,
                                                            n_head=n_head))
        np.testing.assert_array_equal(ours, jtm.default_alignment_heads(
            jax_tiny(n_layer=n_layer, n_head=n_head)))
    mask = ttm.default_alignment_heads(tiny_test_config(n_layer=4, n_head=2))
    assert mask.shape == (4, 2) and not mask[:2].any() and mask[2:].all()


@pytest.mark.parametrize("text,language", [
    (" hello world, again", "en"), (" héllo 你好", "en"), ("你好世界", "zh"),
    ("你好世界", "en"), (" \u201cquoted\u201d words. And more!", "en"),
    (" a-b (c) [d]", "en")])
def test_splits_match_jax(toks, text, language):
    jt, tt = toks
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert ttm.split_tokens_on_unicode(tt, ids) == jtm.split_tokens_on_unicode(jt, ids)
    words, word_tokens = ttm.split_tokens_on_spaces(tt, ids)
    assert (words, word_tokens) == jtm.split_tokens_on_spaces(jt, ids)
    assert ttm.split_to_word_tokens(tt, ids, language) == jtm.split_to_word_tokens(
        jt, ids, language)
    if language == "en":
        assert "".join(words) == text
        assert sum(len(w) for w in word_tokens) == len(ids)
    pieces, groups = ttm.split_tokens_on_unicode(tt, ids)
    assert "".join(pieces) == text and all("\ufffd" not in p for p in pieces)
    assert [t for g in groups for t in g] == ids


def test_split_makes_punctuation_its_own_word_and_unicode_languages(toks):
    _, tt = toks
    words, _ = ttm.split_tokens_on_spaces(tt, tt.encode(" hello world, again"))
    assert "," in words and words[0].strip() == "hello"
    ids = tt.encode("你好世界")
    assert ttm.split_to_word_tokens(tt, ids, "zh")[0] == ["你", "好", "世", "界"]
    assert len(ttm.split_to_word_tokens(tt, ids, "en")[0]) == 1


def test_load_alignment_heads_formats():
    """Every public heads representation parses to the same mask in both
    packages: the (L, H) mask, [layer, head] pairs, their JSON, and
    openai's base85 blob of gzip and of zlib."""
    cfg, jcfg = tiny_test_config(n_layer=4, n_head=4), jax_tiny(n_layer=4, n_head=4)
    want = np.zeros((4, 4), dtype=bool)
    want[2, 1] = want[3, 0] = want[3, 3] = True
    pairs = [[2, 1], [3, 0], [3, 3]]
    for spec in (want, want.tolist(), pairs, json.dumps(pairs),
                 json.dumps(want.tolist()).encode(),
                 base64.b85encode(gzip.compress(want.tobytes())).decode(),
                 base64.b85encode(zlib.compress(want.tobytes()))):
        ours = ttm.load_alignment_heads(spec, cfg)
        np.testing.assert_array_equal(ours, want)
        np.testing.assert_array_equal(ours, jtm.load_alignment_heads(spec, jcfg))
    with pytest.raises(ValueError, match="alignment-heads"):
        ttm.load_alignment_heads([1, 2, 3], cfg)


def test_alignment_heads_from_checkpoint_metadata(tmp_path, monkeypatch):
    """Heads in a checkpoint's metadata reach model.alignment_heads through
    both packages' load_model; a checkpoint without them leaves None."""
    cfg = tiny_test_config(n_state=64, n_head=4, n_layer=4)
    monkeypatch.setitem(tconfig.CONFIGS, "heads-test", cfg)
    jcfg = jax_tiny(n_state=64, n_head=4, n_layer=4)
    from openai_whisper_coreml_tpu import config as jconfig

    monkeypatch.setitem(jconfig.CONFIGS, "heads-test", jcfg)
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    pairs = [[1, 0], [3, 2]]
    path = str(tmp_path / "m.safetensors")
    save_params(params, path, model_name="heads-test",
                extra_meta={"alignment_heads": json.dumps(pairs)})
    ours = load_model("heads-test", checkpoint=path, device="cpu")
    want = np.zeros((4, 4), bool)
    want[1, 0] = want[3, 2] = True
    np.testing.assert_array_equal(ours.alignment_heads, want)
    np.testing.assert_array_equal(
        jax_load_model("heads-test", checkpoint=path).alignment_heads, want)
    bare = str(tmp_path / "bare.safetensors")
    save_params(params, bare, model_name="heads-test")
    assert load_model("heads-test", checkpoint=bare, device="cpu").alignment_heads is None


def test_merge_punctuations_matches_jax():
    pre, app = "\"'\u201c\u00bf([{-", "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"
    spec = [(" \u201c", [1], 0.0, 0.1), ("Hello", [2], 0.1, 0.4), (",", [3], 0.4, 0.45),
            (" world", [4], 0.5, 0.9), (".", [5], 0.9, 1.0), (" (", [6], 1.0, 1.1),
            ("x", [7], 1.1, 1.2)]
    for sets in ((pre, app), ("", "")):
        ours = [ttm.WordTiming(w, list(t), s, e, 0.5) for w, t, s, e in spec]
        ref = [jtm.WordTiming(w, list(t), s, e, 0.5) for w, t, s, e in spec]
        ttm.merge_punctuations(ours, *sets)
        jtm.merge_punctuations(ref, *sets)
        assert [vars(t) for t in ours] == [vars(t) for t in ref]
        assert sum(len(t.tokens) for t in ours) == len(spec)
    ours = [ttm.WordTiming(w, list(t), s, e, 0.5) for w, t, s, e in spec]
    ttm.merge_punctuations(ours, pre, app)
    assert [t.word for t in ours][:5] == ["", " \u201cHello,", "", " world.", ""]
    assert (ours[1].start, ours[1].end) == (0.1, 0.4)


@pytest.mark.parametrize("spans,last_speech", [
    ({" aa": (0.0, 0.3), " bb": (0.35, 0.65), ".": (0.65, 0.7), " cc": (0.7, 5.0)}, 0.0),
    ({" aa": (2.0, 6.5), " bb": (6.5, 6.8), ".": (6.8, 6.9), " cc": (6.9, 7.2)}, 0.0),
    ({" aa": (0.2, 0.5), " bb": (0.5, 0.9), ".": (0.9, 0.9), " cc": (0.9, 1.3)}, 0.1),
])
def test_word_segment_boundary_refinement_matches_jax(toks, spans, last_speech):
    """openai's heuristics on crafted timings (long-word truncation at a
    sentence mark, the first word after silence, segment snapping), two
    segments in one window: words and segment bounds equal JAX's."""
    jt, tt = toks
    seg_texts = [" aa bb.", " cc"]
    ids = [tt.encode(t) for t in seg_texts]
    words, word_tokens = ttm.split_tokens_on_spaces(tt, ids[0] + ids[1])
    out = []
    for mod, tokz, seg_cls in ((ttm, tt, ttr.Segment), (jtm, jt, jtr.Segment)):
        timings = [mod.WordTiming(w, list(tk), *spans[w], 0.9)
                   for w, tk in zip(words, word_tokens)]
        segs = [seg_cls(id=i, seek=0, start=float(i), end=float(i) + 1.0,
                        text=t.strip(), tokens=ids[i] + [tokz.eot], temperature=0.0,
                        avg_logprob=-0.1, compression_ratio=1.0, no_speech_prob=0.0)
                for i, t in enumerate(seg_texts)]
        mod.add_word_timestamps_to_segments(
            None, tokz, segs, None, num_frames=128, time_offset=1.5,
            last_speech_timestamp=last_speech, timings=timings)
        out.append([(s.start, s.end, s.words) for s in segs])
    assert out[0] == out[1]
    if last_speech == 0.0 and spans[" cc"][1] == 5.0:
        cc = out[0][1][2][-1]
        assert cc["end"] - cc["start"] == pytest.approx(0.6, abs=1e-6)


# --- the alignment pass ---------------------------------------------------

def _row(tt, text):
    sot = list(tt.sot_sequence_including_notimestamps)
    return [*sot, *tt.encode(text), tt.eot]


@pytest.mark.parametrize("heads", ["default", "pairs"])
def test_alignment_core_batch_matches_jax(models, toks, heads):
    """The batched core at B=3 with ragged rows in one 64-token bucket:
    matrix and gathered probabilities within 1e-5 of JAX's (fp32 CPU)."""
    jm, tm = models
    jt, tt = toks
    rng = np.random.default_rng(7)
    texts = [" alpha beta gamma", " one two three four five six", " x"]
    rows = [_row(tt, t) for t in texts]
    bucket = 64
    toks_b = np.full((3, bucket), tt.eot, np.int64)
    t_valid = np.array([len(r) for r in rows])
    gather_ids = np.zeros((3, bucket), np.int64)
    for i, r in enumerate(rows):
        toks_b[i, :len(r)] = r
        gather_ids[i, :len(r) - 5] = r[4:-1]  # the text tokens
    text_start = len(tt.sot_sequence_including_notimestamps)
    gather_pos = np.tile(np.clip(text_start - 1 + np.arange(bucket), 0, bucket - 1),
                         (3, 1))
    feats = rng.standard_normal((3, 64, 64)).astype(np.float32)
    mask = (ttm.default_alignment_heads(tm.cfg) if heads == "default"
            else ttm.load_alignment_heads([[0, 1], [1, 0]], tm.cfg))
    jp, jmat = jtm._alignment_core_batch_jit(
        jm.params, jnp.asarray(toks_b, jnp.int32), jnp.asarray(feats),
        jnp.asarray(mask, jnp.float32), jnp.float32(mask.sum()),
        jnp.asarray(t_valid, jnp.int32), jnp.asarray(gather_pos, jnp.int32),
        jnp.asarray(gather_ids, jnp.int32), cfg=jm.cfg, medfilt_width=7)
    tp, tmat = ttm._alignment_core_batch(
        tm, torch.from_numpy(toks_b), torch.from_numpy(feats), mask,
        torch.from_numpy(t_valid), torch.from_numpy(gather_pos),
        torch.from_numpy(gather_ids), 7)
    assert tmat.shape == (3, bucket, 64) and tp.shape == (3, bucket)
    np.testing.assert_allclose(tmat.numpy(), np.asarray(jmat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_frames", [128, 100, 14, 8])
def test_find_word_alignment_matches_jax(models, toks, num_frames):
    """A full window, one cut mid-filter (the host tail fix), one where
    n_audio equals the filter width and one below it (no filter): equal
    times, probabilities within 1e-5, and the timings stay in the window."""
    jm, tm = models
    jt, tt = toks
    feats = np.random.default_rng(4).standard_normal((1, 64, 64)).astype(np.float32)
    text = tt.encode(" alpha beta gamma delta")
    ours = ttm.find_word_alignment(tm, tt, text, feats, num_frames=num_frames)
    ref = jtm.find_word_alignment(jm, jt, text, feats, num_frames=num_frames)
    _assert_timings_equal(ours, ref)
    assert len(ours) == 4
    for w in ours:
        assert 0.0 <= w.start <= w.end <= num_frames / 100 + 1e-6
        assert 0.0 <= w.probability <= 1.0
    assert [w.start for w in ours] == sorted(w.start for w in ours)


def test_find_word_alignment_batch_matches_jax(models, toks):
    """Full windows share one batched forward; a partial window takes the
    single path; an empty one gives []: each equals JAX's batch, and the
    batch equals the single path."""
    jm, tm = models
    jt, tt = toks
    rng = np.random.default_rng(1)
    full = 128
    jobs = [(tt.encode(" alpha beta gamma"),
             rng.standard_normal((64, 64)).astype(np.float32), full),
            (tt.encode(" one two three four five six"),
             rng.standard_normal((64, 64)).astype(np.float32), full),
            (tt.encode(" delta epsilon"),
             rng.standard_normal((64, 64)).astype(np.float32), 40),
            ([], rng.standard_normal((64, 64)).astype(np.float32), full),
            (tt.encode(" a much longer line of words that needs the next bucket"
                       " up from the first one to hold it"),
             rng.standard_normal((64, 64)).astype(np.float32), full)]
    ours = ttm.find_word_alignment_batch(tm, tt, jobs, language="en")
    ref = jtm.find_word_alignment_batch(jm, jt, jobs, language="en")
    assert ours[3] == [] == ref[3]
    for i, (o, r) in enumerate(zip(ours, ref)):
        _assert_timings_equal(o, r)
        if jobs[i][0]:
            single = ttm.find_word_alignment(tm, tt, jobs[i][0], jobs[i][1],
                                             num_frames=jobs[i][2], language="en")
            assert [(w.start, w.end) for w in o] == [(w.start, w.end) for w in single]
