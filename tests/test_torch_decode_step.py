"""Port `decode_step` against the JAX one (fp32, same weights) for what
batched serving adds: the int8 self-attention cache, per-row positions
(continuous batching), `self_kernel=True` (K3's plain version on the CPU),
the per-row cache write layout, and the write guard of a finished row at
pos == cache length (total_len == 448)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models import decoder as jdec
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models import decoder as tdec
from openai_whisper_coreml_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

N_CTX = 32
LOGITS_ATOL = 1e-4  # the int8 cross-KV parity tests' bound (test_torch_decoder)
# K3 rounds q, K and V to bf16: an fp32 difference of ~1e-7 between the two
# frameworks' int8 linears can move one element by a bf16 step (~0.4 %),
# which reaches the logits at ~1e-3. JAX's own test holds K3 to 0.05 of the
# plain path (tests/test_sqa_self.py)
K3_LOGITS_ATOL = 1e-2


@pytest.fixture(scope="module", params=["float", "int8"])
def pair(request):
    """JAX params and the port model on them; 448-token text context."""
    jcfg = jax_tiny(n_audio_ctx=N_CTX)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    if request.param == "int8":
        params = jax_quantize(params, min_size=0)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tiny_test_config(n_audio_ctx=N_CTX))
    feats = np.random.default_rng(2).standard_normal(
        (3, N_CTX, jcfg.n_text_state)).astype(np.float32)
    return jcfg, params, model, feats


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.timestamp_begin, size=(b, t)).astype(np.int32)


def _cross(pair, kv_dtype):
    jcfg, params, model, feats = pair
    if kv_dtype == "int8":
        return (jdec.precompute_cross_kv_int8(params, jcfg, feats),
                tdec.precompute_cross_kv_int8(model.decoder, torch.from_numpy(feats)))
    return (jdec.precompute_cross_kv(params, jcfg, feats),
            tdec.precompute_cross_kv(model.decoder, torch.from_numpy(feats)))


def _caches(pair, cache_dtype, ctx, b=3):
    jcfg, _, model, _ = pair
    if cache_dtype == "int8":
        return (jdec.init_kv_cache_int8(jcfg, b, ctx=ctx),
                tdec.init_kv_cache_int8(model.cfg, b, "cpu", ctx=ctx))
    return (jdec.init_kv_cache(jcfg, b, ctx=ctx),
            tdec.init_kv_cache(model.cfg, b, torch.float32, "cpu", ctx=ctx))


def _assert_caches_equal(jcache, tcache):
    assert type(tcache).__name__ == type(jcache).__name__
    for a, c in zip(jcache, tcache):
        a = np.asarray(a)
        if a.dtype == np.int8:
            # round-half ties may land one step apart (test_torch_decoder)
            assert np.abs(c.numpy().astype(np.int32) - a.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(c.numpy(), a, atol=1e-4, rtol=1e-5)


def _step(pair, jx, tx, jcache, tcache, toks, pos, vf, atol=LOGITS_ATOL, **kw):
    jcfg, params, model, _ = pair
    jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    ref, jcache = jdec.decode_step(params, jcfg, toks, jx, jcache, jpos,
                                   valid_from=jnp.asarray(vf), **kw)
    ours, tcache = tdec.decode_step(model.decoder, torch.from_numpy(toks).long(),
                                    tx, tcache, tpos, valid_from=torch.as_tensor(vf),
                                    **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol)
    return ours, ref, jcache, tcache


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("valid_from", ["scalar", "per_row"])
def test_int8_cache_prefill_and_steps_match_jax(pair, kv_dtype, valid_from):
    jcfg = pair[0]
    vf = 2 if valid_from == "scalar" else np.array([0, 2, 5], np.int32)
    jx, tx = _cross(pair, kv_dtype)
    jcache, tcache = _caches(pair, "int8", 32)
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 6, 3), 0, vf)
    for i in range(3):
        _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                     _tokens(jcfg, 3, 1, 4 + i), 6 + i, vf)
    _assert_caches_equal(jcache, tcache)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_per_row_positions_match_jax(pair, cache_dtype):
    """Rows at independent positions (continuous batching): three steps with
    a (B,) pos_offset after a lockstep prefill, per-row left-pads."""
    jcfg = pair[0]
    vf = np.array([1, 0, 3], np.int32)
    jx, tx = _cross(pair, "int8")
    jcache, tcache = _caches(pair, cache_dtype, 32)
    # token seeds whose K/V put no int8 value on a rounding tie: a value one
    # int8 step apart moves the logits by ~1e-3 (seed 5 has one)
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 8, 12), 0, vf)
    pos = np.array([8, 11, 20], np.int32)
    for i in range(3):
        _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                     _tokens(jcfg, 3, 1, 13 + i), pos + i, vf)
    _assert_caches_equal(jcache, tcache)
    # two tokens a row at per-row positions is the speculative verify step,
    # ported since; a pos_offset that is not (B,) is still refused
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 2, 17), pos + 3, vf)
    _assert_caches_equal(jcache, tcache)
    with pytest.raises(ValueError, match="per-row"):
        tdec.decode_step(pair[2].decoder, torch.zeros(3, 2, dtype=torch.long), tx,
                         tcache, torch.tensor([1, 2]))


@pytest.mark.parametrize("valid_from", ["scalar", "per_row"])
def test_self_kernel_matches_jax(pair, valid_from):
    """decode_step(self_kernel=True): the port runs K3's plain version, JAX
    its Pallas kernel in interpret mode. The two agree to K3_LOGITS_ATOL;
    each is within 0.05 of the plain path (JAX's own bound, bf16 rounding);
    a short greedy loop gives the same fp32 tokens on both sides."""
    jcfg, params, model, _ = pair
    vf = 2 if valid_from == "scalar" else np.array([1, 2, 3], np.int32)
    jx, tx = _cross(pair, "bf16")
    jcache, tcache = _caches(pair, "bf16", 32)
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 5, 7), 0, vf)
    toks = _tokens(jcfg, 3, 1, 8)
    ours_t, ref_t = [], []
    for pos in range(5, 13):
        plain, _ = jdec.decode_step(params, jcfg, toks, jx, jcache, pos,
                                    valid_from=jnp.asarray(vf))
        ours, ref, jcache, tcache = _step(pair, jx, tx, jcache, tcache, toks, pos,
                                          vf, atol=K3_LOGITS_ATOL,
                                          self_kernel=True)
        assert np.abs(ours.numpy() - np.asarray(plain)).max() < 0.05
        toks = np.asarray(ref)[:, -1].argmax(-1)[:, None].astype(np.int32)
        ref_t.append(toks[:, 0].tolist())
        ours_t.append(ours.numpy()[:, -1].argmax(-1).tolist())
    assert ours_t == ref_t
    _assert_caches_equal(jcache, tcache)


def test_per_row_cache_write_layout():
    """cache[l, rows, :, :, pos] puts the batch dimension first: row b's
    (H, D) column lands at its own position, nothing else moves; the same
    as JAX's per-row scatter."""
    rng = np.random.default_rng(9)
    buf = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    val = rng.standard_normal((3, 4, 5, 1)).astype(np.float32)
    pos = np.array([4, 0, 2], np.int32)
    ref = np.asarray(jdec._cache_write(jnp.asarray(buf), 1, jnp.asarray(val),
                                       jnp.asarray(pos), True))
    ours = torch.from_numpy(buf.copy())
    tdec._cache_write(ours, 1, torch.from_numpy(val),
                      tdec._cache_index(torch.from_numpy(pos), buf.shape[-1]))
    np.testing.assert_array_equal(ours.numpy(), ref)
    want = buf.copy()
    for b in range(3):
        want[1, b, :, :, pos[b]] = val[b, :, :, 0]
    np.testing.assert_array_equal(ours.numpy(), want)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_finished_row_at_the_end_of_a_448_cache(pair, cache_dtype):
    """total_len == cache_len == 448: a finished continuous-batching row
    sits at pos == 448, outside the cache. JAX's scatter drops its write;
    the port's guarded write keeps the row's cache, and the logits match."""
    jcfg = pair[0]
    assert jcfg.n_text_ctx == 448
    jx, tx = _cross(pair, "int8")
    jcache, tcache = _caches(pair, cache_dtype, 448)
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 4, 10), 0, 0)
    before = [t.clone() for t in tcache]
    pos = np.array([448, 4, 447], np.int32)
    _, _, jcache, tcache = _step(pair, jx, tx, jcache, tcache,
                                 _tokens(jcfg, 3, 1, 11), pos, 0)
    _assert_caches_equal(jcache, tcache)
    for a, c in zip(before, tcache):
        torch.testing.assert_close(c[:, 0], a[:, 0], rtol=0, atol=0)
