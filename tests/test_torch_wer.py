"""The port's WER and CER (`eval/wer.py`) against the JAX package's: the WER
cases of tests/test_eval_serve.py on both packages, and word_errors,
compute_wer and compute_cer equal to JAX's on the same pairs."""

import numpy as np
import pytest

from openai_whisper_coreml_tpu.eval import wer as jwer
from openai_whisper_coreml_tpu_torch.eval import wer as twer

BOTH = [pytest.param(jwer, id="jax"), pytest.param(twer, id="torch")]


# -- tests/test_eval_serve.py's WER cases, on both packages --------------------

@pytest.mark.parametrize("w", BOTH)
def test_normalize_text(w):
    assert w.normalize_text("Hello, World!") == "hello world"
    assert w.normalize_text("I can't  do [noise] that") == "i can not do that"
    assert w.normalize_text("they're we've I'll") == "they are we have i will"


@pytest.mark.parametrize("w", BOTH)
def test_word_errors_exact(w):
    assert w.word_errors("a b c".split(), "a b c".split()) == (0, 0, 0, 3)


@pytest.mark.parametrize("w", BOTH)
def test_word_errors_mixed(w):
    # ref: the cat sat | hyp: the bat sat down -> 1 sub + 1 ins
    s, d, i, h = w.word_errors("the cat sat".split(), "the bat sat down".split())
    assert (s, d, i) == (1, 0, 1)
    assert h == 2


@pytest.mark.parametrize("w", BOTH)
def test_compute_wer_multi(w):
    r = w.compute_wer(["the cat sat", "hello world"], ["the cat sat", "hello word"])
    assert r.n_ref_words == 5
    assert r.substitutions == 1
    assert abs(r.wer - 0.2) < 1e-9


@pytest.mark.parametrize("w", BOTH)
def test_wer_empty_hyp(w):
    r = w.compute_wer(["three word reference"], [""])
    assert r.deletions == 3
    assert r.wer == 1.0


# -- equal to JAX on the same pairs ---------------------------------------------

PAIRS = [
    ("", ""), ("", "an insertion"), ("a deletion", ""),
    ("the cat sat on the mat", "the cat sat on the mat"),
    ("the cat sat on the mat", "a cat sat on a mat today"),
    ("Mister Brown paid one thousand dollars.", "mr. brown paid $1,000"),
    ("It's twenty twenty-five", "it is 2025"),
    ("The colour of the centre", "the color of the center"),
    ("a b c d e f g", "g f e d c b a"),
    ("one two three four", "one three four five"),
    ("[noise] hello (laughs) world", "hello world"),
    ("Héllo wörld", "hello world"),
]


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_word_errors_equal_jax(ref, hyp):
    r, h = ref.split(), hyp.split()
    assert twer.word_errors(r, h) == jwer.word_errors(r, h)


def _random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    vocab = "the a cat dog sat ran on in mat hill seven forty two".split()

    def sentence():
        return " ".join(rng.choice(vocab, int(rng.integers(0, 14))))

    return [sentence() for _ in range(n)], [sentence() for _ in range(n)]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("language", ["en", None, "fr", "zh"])
def test_compute_wer_and_cer_equal_jax(normalize, language):
    refs, hyps = _random_pairs(3, 40)
    refs += [p[0] for p in PAIRS]
    hyps += [p[1] for p in PAIRS]
    for fn in ("compute_wer", "compute_cer"):
        ours = getattr(twer, fn)(refs, hyps, normalize=normalize, language=language)
        ref = getattr(jwer, fn)(refs, hyps, normalize=normalize, language=language)
        assert ours.as_dict() == ref.as_dict(), fn
    # the CER of a space-less script, characters without whitespace
    zh_r, zh_h = ["今天 天气 很好", "你好"], ["今天天气不好", "你们好"]
    assert twer.compute_cer(zh_r, zh_h, language="zh").as_dict() == \
        jwer.compute_cer(zh_r, zh_h, language="zh").as_dict()


def test_count_mismatch_raises():
    for w in (twer, jwer):
        with pytest.raises(ValueError, match="mismatch"):
            w.compute_wer(["a"], ["a", "b"])
