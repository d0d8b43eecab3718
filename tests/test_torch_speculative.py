"""Port speculative decoding (`speculative.py`) against the JAX package's.

The same weights (`params.from_jax_params`) and the same seeded inputs go
through JAX's and the port's code, fp32 on the CPU:
  * the verify step, `decode_step` over T = K+1 tokens at per-row
    positions with a row running past the cache's end, on the bf16 and
    the int8 self-cache: logits within 1e-5 of JAX's, caches equal;
  * greedy `spec_decode_core` with a disagreeing draft (independent
    weights: the correction path does the work) and with a self-draft (the
    multi-accept bookkeeping does): tokens, n_sampled, n_iters and
    n_drafted equal to JAX's and the tokens to the port's plain loop,
    sum_lp within 1e-4; per-row prompts, int8 cross-KV, and EOT suppressed
    to total_len;
  * sampled mode, which JAX draws with threefry and the port with its own
    hash: seed-exact against the port's plain sampled loop with a
    self-draft, a Monte-Carlo total-variation test against it with a
    disagreeing draft (JAX's test at its sizes), and the grammar and
    determinism;
  * `decode(draft=...)`: the route, the clamp of sample_len, the stats and
    the walls, and `check_pair`.
JAX's mesh test is not mirrored: DP x TP is not ported."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import decoding as jdecoding
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models import decoder as jdec
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.speculative import spec_decode_core as jax_spec
from openai_whisper_coreml_tpu_torch import decoding as tdecoding
from openai_whisper_coreml_tpu_torch import speculative as tspec
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models import decoder as tdec
from openai_whisper_coreml_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

N_AUDIO_CTX = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(n_audio_ctx=N_AUDIO_CTX)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    params_d = jax_init(jcfg, jax.random.PRNGKey(7))
    tcfg = tiny_test_config(n_audio_ctx=N_AUDIO_CTX)
    tm = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    td = from_jax_params(jax.tree.map(np.asarray, params_d), tcfg)
    feats = np.random.default_rng(3).standard_normal(
        (3, jcfg.n_audio_ctx, jcfg.n_audio_state)).astype(np.float32)
    return jcfg, params, params_d, tm, td, feats


def _inputs(cfg, b, prompt_bucket, per_row_pad=False):
    pad = 0 if prompt_bucket <= 4 else 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.timestamp_begin,
                        size=(b, prompt_bucket)).astype(np.int32)
    if per_row_pad:
        pads = np.asarray([0, 2, pad][:b], np.int32)
        for i, p in enumerate(pads):
            toks[i, :p] = cfg.eot_token
            toks[i, p] = cfg.sot_token
        return toks, pads, pads
    toks[:, pad] = cfg.sot_token
    return toks, np.full((b,), pad, np.int32), np.full((b,), pad, np.int32)


def _masks(cfg, suppress=None):
    sup = np.zeros(cfg.n_vocab, bool) if suppress is None else suppress
    return sup, np.zeros(cfg.n_vocab, bool)


def _jax_spec(setup, params_d, feats, toks, pads, sots, *, sample_len,
              use_timestamps, spec_k, kv_dtype="bf16"):
    jcfg, params = setup[0], setup[1]
    sup, blank = _masks(jcfg)
    out = jax_spec(params, params_d, jcfg, jcfg, jnp.asarray(feats),
                   jnp.asarray(feats), jnp.asarray(toks), jnp.asarray(sup),
                   jnp.asarray(blank), jnp.int32(50), jnp.asarray(pads),
                   jnp.asarray(sots), None, None, sample_len=sample_len,
                   use_timestamps=use_timestamps, prompt_len=toks.shape[1],
                   spec_k=spec_k, kv_dtype=kv_dtype, sampled=False)
    return [np.asarray(o) for o in out]


def _port_spec(tm, draft, feats, toks, pads, sots, *, sample_len,
               use_timestamps, spec_k, kv_dtype="bf16", temperature=None,
               seed=1, suppress=None):
    sup, blank = _masks(tm.cfg, suppress)
    x = torch.from_numpy(feats)
    out = tspec.spec_decode_core(
        tm.decoder, draft.decoder, x, x, torch.from_numpy(toks),
        torch.from_numpy(sup), torch.from_numpy(blank), 50,
        torch.from_numpy(pads).long(), torch.from_numpy(sots).long(),
        sample_len=sample_len, use_timestamps=use_timestamps,
        prompt_len=toks.shape[1], spec_k=spec_k, kv_dtype=kv_dtype,
        sampled=temperature is not None, temperature=temperature or 0.0,
        seed=seed)
    return [o.numpy() for o in out]


def _port_plain(tm, feats, toks, pads, sots, *, sample_len, use_timestamps,
                kv_dtype="bf16", temperature=0.0, seed=1, suppress=None):
    sup, blank = _masks(tm.cfg, suppress)
    out = tdecoding.greedy_decode_core(
        tm.decoder, torch.from_numpy(feats), torch.from_numpy(toks),
        torch.from_numpy(sup), torch.from_numpy(blank), 50,
        torch.from_numpy(pads).long(), torch.from_numpy(sots).long(),
        sample_len=sample_len, use_timestamps=use_timestamps,
        prompt_len=toks.shape[1], kv_dtype=kv_dtype, temperature=temperature,
        seed=seed)
    return [o.numpy() for o in out]


def _assert_matches_jax(ours, ref, plain):
    np.testing.assert_array_equal(ours[0], ref[0])  # tokens
    for i in (2, 4, 5):  # n_sampled, n_iters, n_drafted
        np.testing.assert_array_equal(ours[i], ref[i])
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)  # sum_lp
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-5)  # no_speech
    np.testing.assert_array_equal(ours[0], plain[0])
    np.testing.assert_array_equal(ours[2], plain[2])


# -- the verify step ----------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_verify_step_matches_jax(setup, cache_dtype):
    """T = K+1 = 5 tokens at per-row positions after a lockstep prefill: a
    row well inside, one further on, and one whose last two columns lie
    past the 32-column cache (JAX's scatter drops them, the port keeps the
    cache's contents there). Two verify steps, so the second reads what the
    first wrote. Each step starts JAX from the port's cache, the port's
    prefill's included: an int8 rounding tie in an earlier write puts one
    code a step apart (~1e-3 in the logits, test_torch_decode_step.py),
    which is not the step under test; every cache a verify step writes is
    held equal within one int8 step."""
    jcfg, params, _, tm, _, feats = setup
    ctx, b, t = 32, 3, 5
    vf = np.array([0, 2, 1], np.int32)
    jx = jdec.precompute_cross_kv(params, jcfg, feats)
    tx = tdec.precompute_cross_kv(tm.decoder, torch.from_numpy(feats))
    if cache_dtype == "int8":
        jc = jdec.init_kv_cache_int8(jcfg, b, ctx=ctx)
        tc = tdec.init_kv_cache_int8(tm.cfg, b, "cpu", ctx=ctx)
    else:
        jc = jdec.init_kv_cache(jcfg, b, ctx=ctx)
        tc = tdec.init_kv_cache(tm.cfg, b, torch.float32, "cpu", ctx=ctx)
    rng = np.random.default_rng(5)

    def step(jc, tc, toks, pos):
        _assert_caches_close(jc, tc)
        jc = type(jc)(*(jnp.asarray(c.numpy()) for c in tc))
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos).long()
        ref, jc = jdec.decode_step(params, jcfg, jnp.asarray(toks), jx, jc, jpos,
                                   valid_from=jnp.asarray(vf))
        ours, tc = tdec.decode_step(tm.decoder, torch.from_numpy(toks).long(), tx,
                                    tc, tpos, valid_from=torch.from_numpy(vf).long())
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        return jc, tc

    # the prefill (the port's; its parity is test_torch_decode_step's)
    toks = rng.integers(0, jcfg.timestamp_begin, size=(b, 8)).astype(np.int32)
    tdec.decode_step(tm.decoder, torch.from_numpy(toks).long(), tx, tc, 0,
                     valid_from=torch.from_numpy(vf).long())
    jc = type(jc)(*(jnp.asarray(c.numpy()) for c in tc))
    for pos in (np.array([8, 13, ctx - 3], np.int32),
                np.array([10, 18, ctx - 1], np.int32)):
        toks = rng.integers(0, jcfg.timestamp_begin, size=(b, t)).astype(np.int32)
        jc, tc = step(jc, tc, toks, pos)
    _assert_caches_close(jc, tc)


def _assert_caches_close(jc, tc):
    for a, c in zip(jc, tc):
        a = np.asarray(a)
        if a.dtype == np.int8:
            # round-half ties may land one int8 step apart
            assert np.abs(c.numpy().astype(np.int32) - a.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(c.numpy(), a, atol=1e-5)


@pytest.mark.parametrize("pos", [[0, 5, 14], [2, 15, 20]])
def test_verify_write_is_the_per_token_writes(setup, pos):
    """The per-row block write puts token j of row b at column pos[b] + j in
    (B, H, D, C) order, not transposed: the same cache as T single-token
    per-row writes. Columns past the 16-column cache keep their contents,
    a row starting at C - 1 or past C included. self_kernel stays refused
    for T > 1, as in JAX."""
    _, _, _, tm, _, feats = setup
    c, t = 16, 4
    pos = torch.tensor(pos)
    val = torch.randn(3, 2, 5, t, generator=torch.Generator().manual_seed(0))
    block = torch.full((1, 3, 2, 5, c), 7.0)
    single = block.clone()
    tdec._cache_write(block, 0, val, tdec._cache_index(pos, c, t))
    for j in range(t):
        tdec._cache_write(single, 0, val[..., j:j + 1],
                          tdec._cache_index(pos + j, c))
    assert torch.equal(block, single)
    for b in range(3):
        for j in range(t):
            col = int(pos[b]) + j
            if col < c:
                assert torch.equal(block[0, b, :, :, col], val[b, :, :, j])
    x = tdec.precompute_cross_kv(tm.decoder, torch.from_numpy(feats))
    cache = tdec.init_kv_cache(tm.cfg, 3, torch.float32, "cpu", ctx=c)
    with pytest.raises(ValueError, match="self_kernel"):
        tdec.decode_step(tm.decoder, torch.zeros(3, t, dtype=torch.long), x,
                         cache, pos, self_kernel=True)


# -- greedy -----------------------------------------------------------------------

@pytest.mark.parametrize(
    "bucket,sample_len,use_ts,spec_k",
    [(4, 40, True, 3), (4, 40, False, 3), (32, 60, True, 5), (4, 25, True, 1)],
    ids=["ts-k3", "nots-k3", "bucket32-k5", "k1"])
def test_spec_token_exact_disagreeing_draft(setup, bucket, sample_len, use_ts,
                                            spec_k):
    jcfg, _, params_d, tm, td, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, bucket)
    kw = dict(sample_len=sample_len, use_timestamps=use_ts)
    ref = _jax_spec(setup, params_d, feats, toks, pads, sots, spec_k=spec_k, **kw)
    ours = _port_spec(tm, td, feats, toks, pads, sots, spec_k=spec_k, **kw)
    _assert_matches_jax(ours, ref, _port_plain(tm, feats, toks, pads, sots, **kw))


def test_spec_self_draft_full_acceptance(setup):
    """Draft == target: every proposal matches, so the loop commits K+1
    tokens per verify step and stays token-exact."""
    jcfg, params, _, tm, _, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 4)
    kw = dict(sample_len=40, use_timestamps=True)
    ref = _jax_spec(setup, params, feats, toks, pads, sots, spec_k=4, **kw)
    ours = _port_spec(tm, tm, feats, toks, pads, sots, spec_k=4, **kw)
    _assert_matches_jax(ours, ref, _port_plain(tm, feats, toks, pads, sots, **kw))
    stats = tspec.spec_stats(ours[2], ours[4], ours[5])
    assert stats["tokens_per_iter"] > 3.5, stats
    assert stats["acceptance_rate"] > 0.85, stats


def test_spec_per_row_prompts(setup):
    jcfg, _, params_d, tm, td, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 8, per_row_pad=True)
    kw = dict(sample_len=30, use_timestamps=True)
    ref = _jax_spec(setup, params_d, feats, toks, pads, sots, spec_k=3, **kw)
    ours = _port_spec(tm, td, feats, toks, pads, sots, spec_k=3, **kw)
    _assert_matches_jax(ours, ref, _port_plain(tm, feats, toks, pads, sots, **kw))


def test_spec_int8_cross_kv(setup):
    jcfg, _, params_d, tm, td, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 4)
    kw = dict(sample_len=30, use_timestamps=True, kv_dtype="int8")
    ref = _jax_spec(setup, params_d, feats, toks, pads, sots, spec_k=3, **kw)
    ours = _port_spec(tm, td, feats, toks, pads, sots, spec_k=3, **kw)
    _assert_matches_jax(ours, ref, _port_plain(tm, feats, toks, pads, sots, **kw))


def test_spec_eot_suppressed_runs_to_total_len(setup):
    """With EOT never committed, every row stops exactly at total_len and
    the candidate slack never reaches the returned buffer; JAX's tokens and
    counts, at a horizon not aligned to K+1."""
    jcfg, params, _, tm, _, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 4)
    kw = dict(sample_len=23, use_timestamps=True)
    ref = _jax_spec(setup, params, feats, toks, pads, sots, spec_k=4, **kw)
    ours = _port_spec(tm, tm, feats, toks, pads, sots, spec_k=4, **kw)
    _assert_matches_jax(ours, ref, _port_plain(tm, feats, toks, pads, sots, **kw))
    tokens, n_sampled = ours[0], ours[2]
    assert tokens.shape[1] == 4 + 23
    for i in range(3):
        eots = np.nonzero(tokens[i, 4:] == jcfg.eot_token)[0]
        assert (int(eots[0]) if len(eots) else 23) == int(n_sampled[i])


def test_spec_through_decode_api(setup):
    """decode(model, ..., draft=...) end to end, text included, against the
    port's plain decode and JAX's decode with the same draft."""
    jcfg, params, params_d, tm, td, feats = setup
    kw = dict(language="en", sample_len=24, spec_k=3)
    base = tdecoding.decode(tm, feats, tdecoding.DecodingOptions(**kw),
                            from_features=True)
    spec = tdecoding.decode(tm, feats, tdecoding.DecodingOptions(**kw),
                            from_features=True, draft=td)
    ref = jdecoding.decode(JaxModel(cfg=jcfg, params=params), feats,
                           jdecoding.DecodingOptions(**kw), from_features=True,
                           draft=JaxModel(cfg=jcfg, params=params_d))
    assert [r.tokens for r in base] == [r.tokens for r in spec]
    assert [r.tokens for r in ref] == [r.tokens for r in spec]
    assert [r.text for r in base] == [r.text for r in spec]
    for a, b in zip(ref, spec):
        assert abs(a.avg_logprob - b.avg_logprob) < 1e-4
        assert abs(a.no_speech_prob - b.no_speech_prob) < 1e-5
    assert tspec.LAST_TIMING["path"] == "spec" and tspec.LAST_TIMING["k"] == 3
    # units: the slowest row's iterations, which the wall paid for
    assert 0 < tspec.LAST_TIMING["units"] <= tspec.LAST_STATS["iters"]


def test_decode_clamps_sample_len_and_keeps_int8_cache_plain(setup):
    """The draft's candidate writes need K+1 columns past the horizon, so
    decode clamps sample_len to n_text_ctx - prompt_len - spec_k - 1 (as
    JAX's route does); an int8 self-cache keeps the plain loop."""
    jcfg, params, _, tm, td, feats = setup
    n_ctx = tm.cfg.n_text_ctx
    opts = tdecoding.DecodingOptions(language="en", sample_len=n_ctx, spec_k=4,
                                     suppress_tokens=[tm.cfg.eot_token])
    before = dict(tspec.TOTALS)
    res = tdecoding.decode(tm, feats[:1], opts, from_features=True, draft=tm)
    assert len(res[0].tokens) <= n_ctx - 4 - 4 - 1
    assert tspec.TOTALS["iters"] > before["iters"]
    mid = dict(tspec.TOTALS)
    tdecoding.decode(tm, feats[:1], tdecoding.DecodingOptions(
        language="en", sample_len=8, cache_dtype="int8"), from_features=True,
        draft=td)
    assert tspec.TOTALS == mid and tspec.LAST_TIMING["path"] == "plain"


# -- sampled (rejection) speculative decoding ---------------------------------

def test_spec_sampled_seed_exact_self_draft(setup):
    """Draft == target at temperature > 0: every ratio p/q is 1, nothing is
    rejected, and the per-(row, position) noise makes the committed
    sequence seed-exact against the port's plain sampled loop."""
    jcfg, _, _, tm, _, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 4)
    for temp, seed in ((0.8, 1), (1.3, 5)):
        kw = dict(sample_len=36, use_timestamps=True, temperature=temp, seed=seed)
        plain = _port_plain(tm, feats, toks, pads, sots, **kw)
        spec = _port_spec(tm, tm, feats, toks, pads, sots, spec_k=4, **kw)
        np.testing.assert_array_equal(plain[0], spec[0])
        np.testing.assert_array_equal(plain[2], spec[2])
        np.testing.assert_allclose(plain[1], spec[1], atol=1e-4)


def test_spec_sampled_distribution_preserved(setup):
    """Rejection sampling keeps the committed sequence distributed as the
    plain sampled loop's: Monte-Carlo over seeds with a disagreeing draft
    (frequent rejections: the residual path does real work), on the joint
    frequency of the first two sampled tokens, at JAX's test's sizes. The
    suppression mask leaves 12 live tokens (the rules filter p and q
    alike); a residual bug (committing from q, or reusing the rejected
    proposal's noise) moves the TV to ~0.5."""
    jcfg, _, _, tm, td, _ = setup
    b, n_seeds = 32, 100
    feats = np.random.default_rng(17).standard_normal(
        (b, jcfg.n_audio_ctx, jcfg.n_audio_state)).astype(np.float32)
    toks, pads, sots = _inputs(jcfg, b, 4)
    allowed = np.arange(100, 112)
    suppress = np.ones(jcfg.n_vocab, bool)
    suppress[allowed] = False  # EOT stays suppressed: rows decode 2 tokens
    kw = dict(sample_len=2, use_timestamps=False, temperature=1.0,
              suppress=suppress)
    joint_plain, joint_spec = Counter(), Counter()
    rejected = 0
    for seed in range(n_seeds):
        plain = _port_plain(tm, feats, toks, pads, sots, seed=seed, **kw)
        spec = _port_spec(tm, td, feats, toks, pads, sots, spec_k=1, seed=seed,
                          **kw)
        joint_plain.update((int(r[4]), int(r[5])) for r in plain[0])
        joint_spec.update((int(r[4]), int(r[5])) for r in spec[0])
        stats = tspec.spec_stats(spec[2], spec[4], spec[5])
        rejected += stats["drafted"] - (stats["tokens"] - stats["iters"])
    n = b * n_seeds
    keys = set(joint_plain) | set(joint_spec)
    tv = 0.5 * sum(abs(joint_plain[k] - joint_spec[k]) for k in keys) / n
    for t1, t2 in keys:  # every committed token obeys the grammar
        assert t1 in allowed and t2 in allowed
    assert rejected > n_seeds, rejected  # the residual path ran
    assert tv < 0.15, (tv, sorted(joint_plain.items())[:8],
                       sorted(joint_spec.items())[:8])


def test_spec_sampled_grammar_and_determinism(setup):
    """Sampled speculative decoding under the timestamp grammar: the same
    seed gives the same output, another seed moves tokens, and rows end
    inside the horizon with sane counts."""
    jcfg, _, _, tm, td, feats = setup
    toks, pads, sots = _inputs(jcfg, 3, 4)
    kw = dict(sample_len=30, use_timestamps=True, spec_k=3, temperature=0.7)
    a = _port_spec(tm, td, feats, toks, pads, sots, seed=9, **kw)
    b_ = _port_spec(tm, td, feats, toks, pads, sots, seed=9, **kw)
    np.testing.assert_array_equal(a[0], b_[0])
    np.testing.assert_array_equal(a[2], b_[2])
    c = _port_spec(tm, td, feats, toks, pads, sots, seed=10, **kw)
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape[1] == 4 + 30
    assert (a[2] <= 30).all() and (a[2] >= 1).all()
    ts = jcfg.timestamp_begin
    for row, n in zip(a[0], a[2]):  # timestamps never decrease
        stamps = [t for t in row[4:4 + n] if t >= ts]
        assert stamps == sorted(stamps)
        assert all(0 <= t < jcfg.n_vocab for t in row)


def test_spec_sampled_through_decode_api(setup):
    """decode(draft=..., temperature > 0) routes to the sampled core and
    reports a speculative decode; best_of fan-outs keep the plain loop and
    publish no wall."""
    _, _, _, tm, td, feats = setup
    opts = tdecoding.DecodingOptions(language="en", sample_len=16, spec_k=3,
                                     temperature=0.8)
    before = dict(tspec.TOTALS)
    r1 = tdecoding.decode(tm, feats, opts, from_features=True, draft=td, seed=3)
    assert tspec.TOTALS["iters"] > before["iters"]
    assert tspec.LAST_TIMING["path"] == "spec"
    assert tspec.LAST_TIMING["temperature"] == pytest.approx(0.8)
    r2 = tdecoding.decode(tm, feats, opts, from_features=True, draft=td, seed=3)
    assert [r.tokens for r in r1] == [r.tokens for r in r2]
    before = dict(tspec.TOTALS)
    tdecoding.decode(tm, feats, tdecoding.DecodingOptions(
        language="en", sample_len=8, temperature=0.8, best_of=2),
        from_features=True, draft=td, seed=3)
    assert tspec.TOTALS["iters"] == before["iters"]
    assert tspec.LAST_TIMING is None


def test_spec_draft_token_space_mismatch():
    cfg = tiny_test_config(n_audio_ctx=N_AUDIO_CTX)
    bad = tiny_test_config(n_vocab=51866, n_audio_ctx=N_AUDIO_CTX)
    with pytest.raises(ValueError, match="token spaces differ"):
        tspec.check_pair(cfg, bad)


def _plain_loop_noise(seed, rows, pos, n_vocab):
    """The sampler's noise as every plain sampled loop has drawn it since
    the sampler was ported: the 32-bit mixer on int64, out of place."""
    m = 0xFFFFFFFF

    def mix(x):
        x = x ^ (x >> 16)
        x = (x * 0x7FEB352D) & m
        x = x ^ (x >> 15)
        x = (x * 0x5BD1E995) & m
        return x ^ (x >> 16)

    key = mix(mix(torch.tensor(seed & m)) ^ (pos & m))
    bits = mix(mix(mix(key ^ (rows.long() & m))[:, None] ^ torch.arange(n_vocab)))
    u = ((bits >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def test_tagged_noise_streams(setup):
    """Untagged draws at an integer position are the plain loops' bits,
    bit for bit; a (B,) position tensor gives each row its own position's
    draws; the tagged streams (1: the residual commit, 2: the acceptance
    uniform) are other draws."""
    for seed, pos in ((0, 0), (3, 17), (2**33 + 5, 447), (9, 2**32 + 3)):
        assert torch.equal(tdecoding.gumbel_noise(seed, torch.arange(7), pos, 999),
                           _plain_loop_noise(seed, torch.arange(7), pos, 999))
    rows = torch.arange(5)
    pos = torch.tensor([3, 9, 9, 40, 447])
    per_row = tdecoding.gumbel_noise(4, rows, pos, 300)
    for i in range(5):
        at = tdecoding.gumbel_noise(4, rows, int(pos[i]), 300)
        assert torch.equal(per_row[i], at[i])
    tagged = {tag: tdecoding.gumbel_noise(4, rows, pos, 300, tag) for tag in (1, 2)}
    assert not torch.equal(tagged[1], per_row)
    assert not torch.equal(tagged[1], tagged[2])
    u = tdecoding.uniform_noise(4, rows, pos, tag=2)
    assert u.shape == (5,) and ((u > 0) & (u < 1)).all()
    assert torch.equal(u, tdecoding.uniform_noise(4, rows, pos, tag=2))
