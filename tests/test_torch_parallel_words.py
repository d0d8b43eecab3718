"""Word timestamps under the port's DP x TP mesh against JAX's unsharded
model, on gloo ranks spawned on the CPU (fp32, the same weights).

Under a model axis each rank's alignment forward holds only its heads: a
rank standardises and filters its own selected heads and the per-head
sums are all-reduced over the model group (`timing.py`). Every rank's
words from `transcribe` (with and without
`hallucination_silence_threshold`) and `transcribe_batch` (both
schedulers), and `find_word_alignment` at each branch of a window (full,
the host tail fix, n_audio equal to and below the filter width) and
`find_word_alignment_batch`, equal JAX's: times exact, probabilities
within 1e-5. A mask whose heads all sit on model rank 0 leaves rank 1
with none, which must still join every sum."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jsv
from openai_whisper_coreml_tpu import timing as jtm
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer as jax_tokenizer
from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

from . import torch_parallel_worker as worker
from .test_torch_wordts import assert_words_equal, speechy

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 1), (2, 2)]
IDS = [f"{d}x{m}" for d, m in MESHES]


def _numpy_tree(cfg, seed):
    return jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights and inputs, written for the ranks, and JAX's unsharded
    results for each mask."""
    d = tmp_path_factory.mktemp("words")
    cfg, acfg = jax_tiny(**worker.SERVE_SIZE), jax_tiny(**worker.ALIGN_SIZE)
    params, aparams = _numpy_tree(cfg, 1), _numpy_tree(acfg, 0)
    np.savez(d / "serve_params.npz", **flatten_params(params))
    np.savez(d / "align_params.npz", **flatten_params(aparams))
    clip, clips = speechy(35, 3), [speechy(12, 21), speechy(35, 22)]
    feats = np.random.default_rng(4).standard_normal((4, 64, 128)).astype(np.float32)
    np.savez(d / "words_inputs.npz", clip=clip, b0=clips[0], b1=clips[1], feats=feats)

    tok = jax_tokenizer(acfg, language="en")
    text = tok.encode(" alpha beta gamma delta")
    want = {}
    for tag in ("default", "sparse"):
        heads = (jtm.load_alignment_heads(worker.SPARSE_HEADS, cfg)
                 if tag == "sparse" else None)
        jm = JaxModel(cfg=cfg, params=params, alignment_heads=heads)
        for thr in ((None, 0.5) if tag == "default" else (None,)):
            want[("transcribe", tag, thr)] = jm.transcribe(
                clip, hallucination_silence_threshold=thr, **worker.WORDS_KW)
        for scheduler in ("static", "continuous"):
            want[("batch", tag, scheduler)] = jsv.transcribe_batch(
                jm, clips, jsv.ServeOptions(scheduler=scheduler, **worker.BATCH_WORDS_KW))
        am = JaxModel(cfg=acfg, params=aparams, alignment_heads=(
            jtm.load_alignment_heads(worker.SPARSE_HEADS, acfg) if tag == "sparse"
            else None))
        for frames in worker.ALIGN_FRAMES:
            want[("align", tag, frames)] = worker.timings(jtm.find_word_alignment(
                am, tok, text, feats[:1], num_frames=frames))
        jobs = [(text, feats[1], 128), (tok.encode(" one two three"), feats[2], 128),
                (tok.encode(" x y"), feats[3], 40)]
        want[("align_batch", tag)] = [worker.timings(t) for t in
                                      jtm.find_word_alignment_batch(am, tok, jobs,
                                                                    language="en")]
    return {"dir": str(d), "want": want}


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def ranks(request, setup):
    """Every rank's words for one mesh (one spawn per mesh); the
    hallucination threshold on (1, 2) only."""
    n_data, n_model = request.param
    return (n_data, n_model), worker.spawn(
        n_data * n_model, worker.words_checks, n_data, n_model, setup["dir"],
        request.param == (1, 2))


def _assert_timings_equal(ours, ref):
    assert [t[:4] for t in ours] == [t[:4] for t in ref]
    for o, r in zip(ours, ref):
        assert o[4] == pytest.approx(r[4], abs=1e-5)


def _keys(results, kind):
    return [k for k in results[0] if k[0] == kind]


def test_transcribe_words_equal_jax_unsharded(ranks, setup):
    """A 35 s clip (a full window, then a partial one with the tail fix and
    the seek from the last word), with the default heads, the sparse mask
    on a model axis and, on (1, 2), a hallucination threshold: every
    rank's segments and words are JAX's."""
    mesh, results = ranks
    keys = _keys(results, "transcribe")
    assert len(keys) == {(1, 2): 3, (2, 1): 1, (2, 2): 2}[mesh]
    for key in keys:
        for res in results:
            assert_words_equal(res[key], setup["want"][key])
        assert any(s["words"] for s in results[0][key]["segments"]), key


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_transcribe_batch_words_equal_jax_unsharded(ranks, setup, scheduler):
    """Two requests (12 s: one partial window; 35 s: a full window through
    the batched core, then a partial one), split over the data groups:
    every rank returns both requests with JAX's words."""
    results = ranks[1]
    keys = [k for k in _keys(results, "batch") if k[2] == scheduler]
    assert keys
    for key in keys:
        for res in results:
            assert len(res[key]) == 2
            for o, r in zip(res[key], setup["want"][key]):
                assert_words_equal(o, r)


def test_alignment_branches_equal_jax_unsharded(ranks, setup):
    """find_word_alignment at 128, 100, 14 and 8 frames and
    find_word_alignment_batch (two full windows and a partial one):
    equal times, probabilities within 1e-5, on every rank."""
    results = ranks[1]
    keys = _keys(results, "align") + _keys(results, "align_batch")
    assert keys
    for key in keys:
        for res in results:
            got, want = res[key], setup["want"][key]
            if key[0] == "align_batch":
                assert len(got) == len(want)
                for o, r in zip(got, want):
                    _assert_timings_equal(o, r)
            else:
                assert len(got) == 4
                _assert_timings_equal(got, want)


def test_sparse_mask_leaves_a_rank_no_head(ranks, setup):
    """On a model axis the sparse mask's heads are all model rank 0's: the
    other rank's cut of the mask is empty, and its words are rank 0's."""
    (_, n_model), results = ranks
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.timing import load_alignment_heads

    mask = load_alignment_heads(worker.SPARSE_HEADS, tiny_test_config(**worker.SERVE_SIZE))
    per = mask.shape[1] // 2
    assert mask[:, :per].any() and not mask[:, per:].any()
    sparse = [k for k in results[0] if k[1] == "sparse"]
    assert bool(sparse) == (n_model > 1)
    for key in sparse:
        assert all(res[key] == results[0][key] for res in results)


def test_cli_word_timestamps_under_tensor_parallel(tmp_path):
    """`cli --word-timestamps --tensor-parallel 2`: rank 0 alone writes the
    JSON, whose words are the one-process CLI's."""
    import json

    from openai_whisper_coreml_tpu_torch.utils import audio_io

    wav = str(tmp_path / "clip.wav")
    audio_io.save_wav(wav, speechy(6, 7), 16000)
    args = [wav, "--language", "en", "--word-timestamps", "--output-format", "json",
            "--temperature-increment-on-fallback", "0"]
    worker.cli_capture(args + ["-o", str(tmp_path / "one")])
    got = worker.spawn(2, worker.cli_capture, args + ["--tensor-parallel", "2", "-o",
                                                      str(tmp_path / "tp")])
    assert " -> " in got[0][1] and got[1] == ("", "")
    one, tp = (json.loads((tmp_path / d / "clip.json").read_text()) for d in ("one", "tp"))
    assert_words_equal(tp, one)
    assert any(s["words"] for s in tp["segments"])
