"""The Hopper kernels (flash attention, log-mel, decode self-attention K3,
int8 single-query attention K6, int8 x int8 cross-attention K2) against
their plain versions, on the card (the log-mel also against the fp64
oracle of tests/oracles.py).

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch import audio as taudio
from openai_whisper_coreml_tpu_torch import quantize as tq
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod
from openai_whisper_coreml_tpu_torch.models.whisper import build_model
from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk
from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

from .oracles import oracle_log_mel

NO_CARD = "needs an NVIDIA GPU with nvcc (the kernel has no CPU mode)"


def _close(out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3
    else:
        assert err.max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("shape", [(4, 1500, 1500, 20), (1, 77, 77, 2),
                                   (2, 100, 300, 2)])
def test_kernel_matches_plain_version_on_card(shape, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    b, tq, tk, h = shape
    q = torch.randn(b, tq, h, 64, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    err = (out.float() - fa.flash_attention_reference(q, k, v).float()).abs()
    assert err.max().item() <= atol
    assert err.mean().item() <= (1e-3 if dtype == torch.bfloat16 else atol)


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_other_shapes():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 64, generator=g, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)  # (B, T, H, D) views with a 3x head stride
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    with pytest.raises(ValueError, match="D=64"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 32, device="cuda"),) * 3)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 64, device="cuda").half(),) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_samples,n_mels", [(4, 480_000, 128),
                                                   (3, 16_000 * 7, 80),
                                                   (1, 16_000 + 160 * 37, 128)])
def test_mel_kernel_matches_plain_version_on_card(batch, n_samples, n_mels):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(batch, n_samples, generator=g, device="cuda") * 0.1
    padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    before = mk.launches
    out = mk.log_mel_kernel(padded, n_mels)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert out.shape == (batch, n_samples // 160, n_mels)
    err = (out - mk.log_mel_kernel_reference(padded, n_mels)).abs()
    assert err.max().item() <= 1e-4
    # the frontend sends CUDA audio through the kernel
    mel = taudio.log_mel_spectrogram(x, n_mels)
    assert mk.launches == before + 2
    assert mel.shape == (batch, n_mels, n_samples // 160)


@pytest.mark.cuda
def test_mel_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    with pytest.raises(ValueError, match="n_mels % 4"):
        mk.log_mel_kernel(torch.zeros(1, 560, device="cuda"), 81)
    with pytest.raises(ValueError, match="160 T"):
        mk.log_mel_kernel(torch.zeros(1, 561, device="cuda"), 80)
    with pytest.raises(TypeError, match="fp32"):
        mk.log_mel_kernel(torch.zeros(1, 560, device="cuda").half(), 80)
    # the kernel checks the table's length against its own layout
    table, pack, ranges = mk._tables(80, torch.device("cuda"))
    x, out = torch.zeros(1, 560, device="cuda"), torch.empty(1, 1, 80, device="cuda")
    err = mk.load_kernel().whisper_log_mel_f32(
        x.data_ptr(), 560, 560, 1, 1, table.data_ptr(), mk.TABLE_FLOATS - 2,
        pack.data_ptr(), ranges.data_ptr(), 80, out.data_ptr(), None)
    assert err == 1  # cudaErrorInvalidValue, before any launch


def _signal(kind, seconds, seed):
    """Audio without energy in most bins: a pure tone, silence, or a
    modulated 200 Hz tone in noise (chip_smoke.speechy)."""
    t = np.arange(int(seconds * 16000)) / 16000
    if kind == "tone":
        return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    if kind == "silence":
        return np.zeros(t.shape, np.float32)
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("kind", ["tone", "silence", "speechy"])
def test_mel_kernel_holds_the_fp64_gate_without_energy_on_card(kind, n_mels):
    """Bins with no real energy hold fp32 rounding noise in the kernel and
    the plain version alike; after the epilogue (floor at max - 8) the
    kernel is within 1e-3 of the fp64 oracle. Silence is -10 in every bin
    before it."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    x = _signal(kind, 30, n_mels)
    before = mk.launches
    mel = taudio.log_mel_spectrogram(torch.from_numpy(x).cuda(), n_mels)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref = oracle_log_mel(x, taudio.mel_filters(n_mels))
    assert np.abs(mel.cpu().numpy() - ref).max() <= 1e-3
    if kind == "silence":
        padded = torch.zeros(2, 160 * 3000 + 400, device="cuda")
        assert (mk.log_mel_kernel(padded, n_mels) == -10.0).all()


def _bounds(b, c, g):
    pos = torch.randint(c // 2, c + 1, (b,), generator=g, device="cuda",
                        dtype=torch.int32)  # c itself: clamped to the last column
    return pos, torch.randint(0, 8, (b,), generator=g, device="cuda", dtype=torch.int32)


# (pos, valid_from) of a row at the edges of the kernel's column split:
# pos inside the first slice (every other CTA of the cluster empty),
# valid_from inside a late slice, pos past the last column (clamped), no
# column in bounds (valid_from > pos: uniform weights), a single column
EDGES = {"pos in the first slice": lambda c: (min(2, c - 1), 0),
         "valid_from in a late slice": lambda c: (c - 1, c - 1 - c // 10),
         "pos past the last column": lambda c: (c + 3, 1),
         "valid_from > pos": lambda c: (c // 2, c // 2 + 1),
         "one column": lambda c: (c // 3, c // 3)}


def _edge_bounds(b, c):
    """Every row at one edge of EDGES, then the rows cycling through them."""
    device = dict(dtype=torch.int32, device="cuda")
    cases = [(torch.tensor([edge(c)[0]] * b, **device),
              torch.tensor([edge(c)[1]] * b, **device)) for edge in EDGES.values()]
    mixed = [list(EDGES.values())[i % len(EDGES)](c) for i in range(b)]
    cases.append((torch.tensor([p for p, _ in mixed], **device),
                  torch.tensor([vf for _, vf in mixed], **device)))
    return cases


def _sqa_inputs(kernel, b, h, c, dtype, seed):
    """q (B, H, 64) in dtype and the kernel's K/V over c columns: bf16 K, V
    (sqa_self) or int8 K, V with fp32 column scales (sqa_int8)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, 64, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(b, h, 64, c, generator=g, device="cuda") for _ in range(2))
    if kernel == "sqa_self":
        return q, (k.bfloat16(), v.bfloat16())
    return q, (*dec_mod.quantize_kv_column(k), *dec_mod.quantize_kv_column(v))


_SQA = {"sqa_self": (ss, ss.sqa_self, ss.sqa_self_reference),
        "sqa_int8": (si, si.sqa_int8, si.sqa_int8_reference)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 20, 256), (3, 20, 448), (2, 2, 7), (1, 20, 448),
                                   (8, 20, 448)])
def test_sqa_self_matches_plain_version_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, c = shape
    q = torch.randn(b, h, 64, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(b, h, 64, c, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    for pos, vf in (_bounds(b, c, g), (c - 1, 0), *_edge_bounds(b, c)):
        before = ss.launches
        out = ss.sqa_self(q, k, v, pos, vf)
        torch.cuda.synchronize()
        assert ss.launches == before + 1 and out.dtype == dtype
        _close(out, ss.sqa_self_reference(q, k, v, pos, vf), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 20, 1500), (4, 20, 256), (2, 2, 9), (8, 20, 1500),
                                   (1, 20, 448), (8, 20, 448)])
def test_sqa_int8_matches_plain_version_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    g = torch.Generator(device="cuda").manual_seed(4)
    b, h, s = shape
    q = torch.randn(b, h, 64, generator=g, device="cuda").to(dtype)
    k8, ks = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    v8, vs = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    for pos, vf in (_bounds(b, s, g), (s - 1, 0), (torch.tensor(s // 2, device="cuda"), 1),
                    *_edge_bounds(b, s)):
        before = si.launches
        out = si.sqa_int8(q, k8, ks, v8, vs, pos, vf)
        torch.cuda.synchronize()
        assert si.launches == before + 1 and out.dtype == dtype
        _close(out, si.sqa_int8_reference(q, k8, ks, v8, vs, pos, vf), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kernel,shape,dtype", [
    ("sqa_int8", (4, 20, 1500), torch.bfloat16), ("sqa_int8", (4, 20, 1500), torch.float32),
    ("sqa_int8", (4, 20, 256), torch.bfloat16), ("sqa_self", (4, 20, 256), torch.bfloat16),
    ("sqa_self", (2, 20, 448), torch.float32)])
def test_forced_split_counts_match_the_plain_version_on_card(kernel, shape, dtype, splits):
    """Any cluster size the caller forces gives the plain version's result
    within the tolerances of the rule's, at per-row and edge bounds."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    mod, wrapper, plain = _SQA[kernel]
    b, h, c = shape
    q, kv = _sqa_inputs(kernel, b, h, c, dtype, seed=splits)
    g = torch.Generator(device="cuda").manual_seed(11)
    for pos, vf in (_bounds(b, c, g), (c - 1, 0), *_edge_bounds(b, c)):
        before = mod.launches
        out = wrapper(q, *kv, pos, vf, splits=splits)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        _close(out, plain(q, *kv, pos, vf), dtype if kernel == "sqa_int8" else torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,c", [("sqa_int8", 1500), ("sqa_int8", 448),
                                      ("sqa_self", 256), ("sqa_self", 7)])
def test_two_launches_give_the_same_bits_on_card(kernel, c):
    """No atomics: the cluster's combine adds in rank order, so the same
    inputs give the same output bits on every launch."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    _, wrapper, _ = _SQA[kernel]
    q, kv = _sqa_inputs(kernel, 8, 20, c, torch.bfloat16, seed=c)
    pos, vf = _bounds(8, c, torch.Generator(device="cuda").manual_seed(12))
    first = wrapper(q, *kv, pos, vf)
    second = wrapper(q, *kv, pos, vf)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,c", [("sqa_int8", 1500), ("sqa_int8", 9),
                                      ("sqa_self", 448), ("sqa_self", 7)])
def test_poisoned_columns_outside_the_bounds_change_nothing_on_card(kernel, c):
    """Columns outside each row's [valid_from, pos] poisoned (NaN in bf16
    K and V; int8 K and V at 127 with NaN scales) leave the output
    bit-identical: they never enter the arithmetic, though a vector load
    may fetch one beside a column in bounds."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    _, wrapper, _ = _SQA[kernel]
    b = 6
    q, kv = _sqa_inputs(kernel, b, 20, c, torch.bfloat16, seed=c + 1)
    pos = torch.tensor([c - 1, c // 2, 2, c + 3, 0, c // 3][:b], dtype=torch.int32,
                       device="cuda").clamp(max=c + 3)
    vf = torch.tensor([0, 1, 1, c // 4, 0, c // 3 - 1][:b], dtype=torch.int32,
                      device="cuda").clamp(min=0)
    clean = wrapper(q, *kv, pos, vf)
    cols = torch.arange(c, device="cuda")
    outside = (cols > pos[:, None]) | (cols < vf[:, None])  # (B, C)
    poisoned = [x.clone() for x in kv]
    for x in poisoned:
        fill = float("nan") if x.is_floating_point() else 127
        x.masked_fill_(outside[:, None, None, :], fill)
    dirty = wrapper(q, *poisoned, pos, vf)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all() and torch.equal(clean, dirty)


@pytest.mark.cuda
def test_split_rule_has_one_mirror_on_card():
    """The C split rule and its Python mirror agree at every column count
    the kernel takes; the kernel refuses more columns or a larger cluster."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    lib = si.load_kernel()
    for rows in (1, 20, 80, 160, 480, 1280):
        for cols in range(1, si.MAX_COLS + 1):
            assert lib.whisper_sqa_split_count(cols, rows) == si.split_count(cols, rows)
    q, kv = _sqa_inputs("sqa_int8", 1, 2, si.MAX_COLS + 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match=f"1..{si.MAX_COLS} columns"):
        si.sqa_int8(q, *kv, 7, 0)
    with pytest.raises(ValueError, match=f"1..{si.MAX_COLS} columns"):
        ss.sqa_self(q, *(torch.zeros(1, 2, 64, si.MAX_COLS + 1, device="cuda"),) * 2, 7, 0)
    with pytest.raises(ValueError, match="splits"):
        si.sqa_int8(q, *(x[..., :64] for x in kv), 7, 0, splits=si.MAX_SPLITS + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("av_int8", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,s_len", [((4, 20, 1536), 1500), ((24, 20, 1536), 1500),
                                         ((2, 2, 9), 7), ((3, 4, 256), None)])
def test_sqa_v3_matches_plain_version_on_card(shape, s_len, dtype, av_int8):
    """K2 against its plain version in both A.V modes; the lane padding
    past s_len, poisoned with 127 and 1e6 scales, leaves the kernel's
    output bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, s = shape
    q = torch.randn(b, h, 64, generator=g, device="cuda").to(dtype)
    k8, ks = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    v8, vs = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    before = sv.launches
    out = sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av_int8)
    torch.cuda.synchronize()
    assert sv.launches == before + 1 and out.dtype == dtype
    _close(out, sv.sqa_cross_int8_reference(q, k8, ks, v8, vs, s_len=s_len,
                                            av_int8=av_int8), dtype)
    if s_len is not None:
        for x, val in ((k8, 127), (v8, 127), (ks, 1e6), (vs, 1e6)):
            x[..., s_len:] = val
        poisoned = sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av_int8)
        torch.cuda.synchronize()
        assert torch.equal(out, poisoned)


def _sqa_v3_inputs(b, h, s, dtype, seed, poison_from=None):
    """q (B, H, 64) in dtype, int8 K/V (B, H, 64, S) with fp32 column
    scales; columns from `poison_from` on hold 127 with 1e6 scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, 64, generator=g, device="cuda").to(dtype)
    k8, ks = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    v8, vs = dec_mod.quantize_kv_column(torch.randn(b, h, 64, s, generator=g, device="cuda"))
    kv = [k8, ks, v8, vs]
    if poison_from is not None:
        for x, val in zip(kv, (127, 1e6, 127, 1e6)):
            x[..., poison_from:] = val
    return q, kv


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,s_len", [((4, 20, 1536), 1500), ((3, 4, 256), 199),
                                         ((2, 2, 203), 201)])
def test_sqa_v3_forced_split_counts_match_the_plain_version_on_card(shape, s_len, dtype,
                                                                    splits):
    """Any cluster size the caller forces gives the plain version's result
    in both A.V modes (16-byte rows, and 203-byte rows on plain loads), and
    the padding past s_len, poisoned with 127 and 1e6 scales, leaves the
    output bit-identical. One CTA cannot stage a 1536-column row's K and V
    (235 KB of shared memory): that launch raises before it runs."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    b, h, s = shape
    q, kv = _sqa_v3_inputs(b, h, s, dtype, seed=splits)
    _, poisoned = _sqa_v3_inputs(b, h, s, dtype, seed=splits, poison_from=s_len)
    for av in (True, False):
        before = sv.launches
        if (s, splits) == (1536, 1):
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                sv.sqa_cross_int8(q, *kv, s_len=s_len, av_int8=av, splits=splits)
            assert sv.launches == before
            continue
        out = sv.sqa_cross_int8(q, *kv, s_len=s_len, av_int8=av, splits=splits)
        dirty = sv.sqa_cross_int8(q, *poisoned, s_len=s_len, av_int8=av, splits=splits)
        torch.cuda.synchronize()
        assert sv.launches == before + 2
        _close(out, sv.sqa_cross_int8_reference(q, *kv, s_len=s_len, av_int8=av), dtype)
        assert torch.equal(out, dirty)


@pytest.mark.cuda
@pytest.mark.parametrize("boost", [False, True])
@pytest.mark.parametrize("splits", [0, 2, 8])
@pytest.mark.parametrize("b", [4, 24])
def test_sqa_v3_int8_codes_are_the_plain_versions_on_card(b, splits, boost):
    """With int8 A.V the kernel divides the integer sum times wmax / 127
    by the softmax sum last, as the plain version does, and only the sum
    is added in another order: if the codes, wmax and the integer sums are
    the plain version's, out / plain is one constant a row (l_plain /
    l_kernel) to within three fp32 roundings. A code one step off moves the
    ratio of every d whose V value there is not 0 by ~|v8| / |sum|, three
    orders above that. With `boost` one column's V scale is raised 50-fold,
    so the largest weight lies in another CTA's slice than the largest
    logit."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, kv = _sqa_v3_inputs(b, 20, 1536, torch.float32, seed=b + splits, poison_from=1500)
    if boost:
        kv[3][..., 1400] *= 50
    out = sv.sqa_cross_int8(q, *kv, s_len=1500, splits=splits)
    plain = sv.sqa_cross_int8_reference(q, *kv, s_len=1500)
    torch.cuda.synchronize()
    nonzero = plain != 0
    assert torch.equal(out != 0, nonzero) and nonzero.float().mean() > 0.99
    ratio = torch.where(nonzero, out / torch.where(nonzero, plain, 1.0), float("nan"))
    row = ratio.nanmedian(dim=-1, keepdim=True).values
    spread = ((ratio - row).abs() / row).nan_to_num(0.0)
    assert spread.max().item() <= 4e-7
    assert (row - 1).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", [(8, 1536), (2, 203)])
def test_sqa_v3_two_launches_give_the_same_bits_on_card(b, s, dtype):
    """No atomics: the combine adds in rank order (int32 with int8 A.V),
    so the same inputs give the same bits on every launch."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, kv = _sqa_v3_inputs(b, 20, s, dtype, seed=s)
    for av in (True, False):
        first = sv.sqa_cross_int8(q, *kv, s_len=s - 3, av_int8=av)
        second = sv.sqa_cross_int8(q, *kv, s_len=s - 3, av_int8=av)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_len", [sv.MAX_COLS, sv.MAX_COLS - 37])
def test_sqa_v3_takes_its_column_limit_on_card(s_len, dtype):
    """12288 columns, the rule's clusters of 16 (768 columns a CTA), both
    A.V modes; one column more is refused."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, kv = _sqa_v3_inputs(1, 4, sv.MAX_COLS, dtype, seed=7)
    assert si.split_count(sv.MAX_COLS, 4) == si.MAX_SPLITS
    for av in (True, False):
        out = sv.sqa_cross_int8(q, *kv, s_len=s_len, av_int8=av)
        torch.cuda.synchronize()
        _close(out, sv.sqa_cross_int8_reference(q, *kv, s_len=s_len, av_int8=av), dtype)
    q, kv = _sqa_v3_inputs(1, 1, sv.MAX_COLS + 1, dtype, seed=8)
    with pytest.raises(ValueError, match=f"1..{sv.MAX_COLS} columns"):
        sv.sqa_cross_int8(q, *kv)


@pytest.mark.cuda
def test_decode_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q = torch.zeros(2, 2, 64, device="cuda")
    k8 = torch.zeros(2, 2, 64, 8, dtype=torch.int8, device="cuda")
    ks = torch.ones(2, 2, 1, 8, device="cuda")
    with pytest.raises(TypeError, match="int8 K/V"):
        si.sqa_int8(q, k8.float(), ks, k8, ks, 7, 0)
    with pytest.raises(ValueError, match="unit column stride"):
        si.sqa_int8(q, k8.transpose(-1, -2).contiguous().transpose(-1, -2), ks,
                    k8, ks, 7, 0)
    with pytest.raises(ValueError, match="per-row bound"):
        si.sqa_int8(q, k8, ks, k8, ks, torch.tensor([1, 2, 3], device="cuda"), 0)
    with pytest.raises(ValueError, match="D=64"):
        ss.sqa_self(torch.zeros(2, 2, 32, device="cuda"),
                    *(torch.zeros(2, 2, 32, 8, device="cuda"),) * 2, 7, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_decode_step_on_card_launches_the_kernels(cache_dtype):
    """Single-token fp32 steps with int8 cross-KV at per-row positions:
    the card (K6, and K6 again for an int8 self-cache) gives the CPU's
    logits; a bf16 cache with self_kernel=True runs K3 per layer."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2, n_audio_ctx=64)
    cpu = build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")  # the same weights on the card
    feats = torch.randn(3, 64, cfg.n_audio_state, generator=torch.Generator().manual_seed(5))
    toks = torch.randint(0, cfg.timestamp_begin, (3, 4),
                         generator=torch.Generator().manual_seed(6))
    pos = torch.tensor([4, 6, 9])
    logits = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = model.device
        cross = dec_mod.precompute_cross_kv_int8(model.decoder, feats.to(dev))
        cache = dec_mod.init_cache(cfg, 3, torch.float32, dev, ctx=16,
                                   cache_dtype=cache_dtype)
        dec_mod.decode_step(model.decoder, toks.to(dev), cross, cache, 0)
        before = si.launches
        out, _ = dec_mod.decode_step(model.decoder, toks[:, :1].to(dev), cross,
                                     cache, pos.to(dev), valid_from=1)
        per_step = 2 if cache_dtype == "int8" else 1
        assert si.launches - before == (cfg.n_text_layer * per_step if dev.type == "cuda"
                                        else 0)
        logits[name] = out.cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0, atol=1e-4)
    if cache_dtype == "bf16":
        cache = dec_mod.init_kv_cache(cfg, 3, torch.bfloat16, "cuda", ctx=16)
        gpu_bf16 = build_model(cfg, dtype=torch.bfloat16, seed=0)
        cross = dec_mod.precompute_cross_kv_int8(gpu_bf16.decoder, feats.cuda().bfloat16())
        assert dec_mod.use_self_kernel(cache)
        before = ss.launches
        dec_mod.decode_step(gpu_bf16.decoder, toks[:, :1].cuda(), cross, cache,
                            pos.cuda(), self_kernel=True)
        assert ss.launches == before + cfg.n_text_layer


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sqa_self", "sqa_int8"])
def test_step_entries_match_the_wrappers_on_card(kernel):
    """decode_step's per-step entries launch the same kernel as the per-call
    wrappers, with the layer's pointers: equal outputs on every layer, one
    launch per call, per-row bounds; a strided q takes the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, s, n_layers = 3, 20, 300, 4
    k, v = (torch.randn(n_layers, b, h, 64, s, generator=g, device="cuda")
            for _ in range(2))
    pos, vf = _bounds(b, s, g)
    if kernel == "sqa_self":
        stacked, mod, wrapper = (k.bfloat16(), v.bfloat16()), ss, ss.sqa_self
        attend = ss.sqa_self_layers(*stacked, pos, vf)
    else:
        stacked = (*dec_mod.quantize_kv_column(k), *dec_mod.quantize_kv_column(v))
        mod, wrapper = si, si.sqa_int8
        attend = si.sqa_int8_layers(*stacked, pos, vf)
    q = torch.randn(b, 1, h, 64, generator=g, device="cuda").bfloat16()
    for l in range(n_layers):
        before = mod.launches
        out = attend(q, l)
        assert mod.launches == before + 1 and out.shape == q.shape
        want = wrapper(q[:, 0], *(t[l] for t in stacked), pos, vf)[:, None]
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    strided = torch.randn(b, h, 1, 64, generator=g, device="cuda").bfloat16().transpose(1, 2)
    torch.testing.assert_close(attend(strided, 1),
                               wrapper(strided[:, 0], *(t[1] for t in stacked), pos,
                                       vf)[:, None], rtol=0, atol=0)
    with pytest.raises(IndexError):
        attend(q, n_layers)


def _counts():
    return fa.launches, fa.launches_causal, fa.launches_online


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,causal", [
    ((4, 448, 448, 20), True), ((2, 37, 37, 2), True), ((1, 130, 130, 2), True),
    ((2, 2048, 2048, 4), True), ((2, 2048, 2048, 4), False),
    ((1, 100, 1600, 2), False)])
def test_causal_and_multi_block_kernel_matches_plain_version_on_card(
        shape, causal, dtype):
    """K1's causal mode and K5 (Tk > 1536): one kernel, each launch counted
    once under the TPU kernel it stands in for."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    b, tq, tk, h = shape
    q = torch.randn(b, tq, h, 64, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    before = _counts()
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    which = 2 if tk > fa.BLOCK_K else (1 if causal else 0)
    assert [a - c for a, c in zip(_counts(), before)] == [int(i == which)
                                                         for i in range(3)]
    _close(out, fa.flash_attention_reference(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
def test_causal_kernel_rejects_unaligned_queries():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    kv = torch.zeros(1, 9, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention(q, kv, kv, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_plain_attention_on_card(causal):
    """The Function's q/k/v gradients (kernel forward, recompute backward)
    against autograd through the plain attention_core, fp32."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from openai_whisper_coreml_tpu_torch.models.layers import attention_core

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = [torch.randn(2, 96, 4, 64, generator=g, device="cuda").requires_grad_()
           for _ in range(3)]
    gout = torch.randn(2, 96, 4, 64, generator=g, device="cuda")
    out = fa.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(out, qkv, gout)
    mask = torch.ones(96, 96, dtype=torch.bool, device="cuda").tril() if causal else None
    ref_out = attention_core(*qkv, mask=mask)
    want = torch.autograd.grad(ref_out, qkv, gout)
    assert (out - ref_out).abs().max().item() <= 2e-5
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.cuda
def test_encoder_projection_gets_its_gradient_through_the_kernel():
    """A loss through the encoder reaches attn.q.w through the kernel's
    output: nonzero, and equal to the plain path's gradient."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    model = build_model(cfg, dtype=torch.float32, seed=0, device="cuda")
    w = model.encoder.blocks[0].attn.q.w
    w.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(4)
    mel = torch.randn(1, cfg.n_mels, 3000, device="cuda", generator=g)
    # a fixed random projection: a loss whose gradient is not the near-zero
    # one of a layer-normed output's mean square
    proj = torch.randn(1, cfg.n_audio_ctx, cfg.n_audio_state, device="cuda",
                       generator=g)
    grads = {}
    for flash in (True, False):
        before = fa.launches
        feats = model.encoder(mel, flash=flash)
        (grads[flash],) = torch.autograd.grad((feats * proj).sum(), [w])
        assert fa.launches - before == (cfg.n_audio_layer if flash else 0)
    assert grads[True].abs().max().item() > 0
    scale = grads[False].abs().max().item()
    assert (grads[True] - grads[False]).abs().max().item() <= 1e-4 * scale


# Key and query counts around the bf16 kernel's 128-key stage (and K5's
# 1536-key boundary), and around its query tile: three warpgroups of 64 rows,
# 192 rows a CTA (at Tq = 37 two warpgroups have no rows, at 129 the third
# has one)
RAGGED_TK = (1, 63, 64, 65, 127, 128, 129, 1500, 1537, 2048)
RAGGED_TQ = (1, 37, 128, 129, 191, 192, 193)


def _qkv(b, tq, tk, h, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, 64, generator=g, device="cuda").to(dtype)
            for t in (tq, tk, tk)]


def _one_counted_launch(q, k, v, causal, dtype):
    """One call adds one to the counter of the TPU kernel it stands in for
    and to no other; its output is finite and within the gate."""
    before = _counts()
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    which = 2 if k.shape[1] > fa.BLOCK_K else (1 if causal else 0)
    assert [a - c for a, c in zip(_counts(), before)] == [int(i == which)
                                                         for i in range(3)]
    assert torch.isfinite(out).all()
    _close(out, fa.flash_attention_reference(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tk", RAGGED_TK)
@pytest.mark.parametrize("tq", RAGGED_TQ)
def test_kernel_matches_plain_version_at_ragged_tiles_on_card(tq, tk, dtype):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    _one_counted_launch(*_qkv(2, tq, tk, 2, dtype, 10_000 * tq + tk), False, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", sorted(set(RAGGED_TK + RAGGED_TQ)))
def test_causal_kernel_matches_plain_version_at_ragged_tiles_on_card(t, dtype):
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    _one_counted_launch(*_qkv(2, t, t, 2, dtype, t), True, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,causal", [(65, False), (193, False), (1500, False),
                                      (1537, False), (129, True), (193, True),
                                      (448, True)])
def test_kernel_never_reads_a_batchs_padding_rows_on_card(t, causal, dtype):
    """q, k, v are [:, :T] views of (B, T + pad, H, 64) buffers whose pad
    rows are NaN: a load (or tensor map) that reads past a batch's last row
    puts NaN into the output."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(t)
    bufs = [torch.randn(3, t + 64, 2, 64, generator=g, device="cuda").to(dtype)
            for _ in range(3)]
    for buf in bufs:
        buf[:, t:] = float("nan")
    _one_counted_launch(*(buf[:, :t] for buf in bufs), causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [32, 64, 128, 256, 512])
def test_causal_kernel_at_the_alignment_buckets_on_card(t, dtype):
    """K1's causal mode at the word-timestamp pass's token buckets, 20
    heads: rows past each batch row's valid length are padding (here huge
    values, then others); the output matches the plain version, is finite,
    and its valid rows do not change when the padding does."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(3, t, t, 20, dtype, t)
    valid = [t // 2 + 1, t - 3, t]
    outs = []
    for fill in (30.0, -7.0):
        for x in (q, k, v):
            for b, n in enumerate(valid):
                x[b, n:] = fill
        _one_counted_launch(q, k, v, True, dtype)
        outs.append(fa.flash_attention(q, k, v, causal=True))
    for b, n in enumerate(valid):
        assert torch.equal(outs[0][b, :n], outs[1][b, :n])


@pytest.mark.cuda
def test_alignment_pass_on_card_matches_cpu():
    """The batched alignment core of a tiny fp32 model (head dim 64, so K1's
    causal mode runs) on the card against the CPU: matrix and token
    probabilities within 1e-5, one causal launch per decoder layer."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openai_whisper_coreml_tpu_torch import timing

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    cpu = build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(3, 1500, 128, generator=g)
    tokens = torch.randint(0, 50_000, (3, 64), generator=g)
    t_valid = torch.tensor([20, 63, 64])
    gather_pos = torch.clamp(3 + torch.arange(64), max=63).expand(3, 64).contiguous()
    heads = timing.default_alignment_heads(cfg)
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = cpu if dev == "cpu" else gpu
        before = fa.launches_causal
        out[name] = [x.cpu() for x in timing._alignment_core_batch(
            model, tokens.to(dev), feats.to(dev), heads, t_valid.to(dev),
            gather_pos.to(dev), tokens.to(dev), 7)]
        if dev == "cuda":
            assert fa.launches_causal - before == cfg.n_text_layer
    for ours, ref in zip(out["card"], out["cpu"]):
        assert (ours - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_speculative_steps_on_card():
    """Speculative decoding's steps on the card. The draft's single-token
    steps at per-row positions (bf16 cache, int8 cross-KV) launch K3 and K6
    once per layer and give the CPU's plain versions' logits within bf16
    tolerance; the verify step (T = K+1 = 5 at per-row positions, one row
    running past the cache) launches no kernel and matches the CPU, in bf16
    within bf16 tolerance and in fp32 within 1e-4; an fp32 speculative
    greedy decode gives the CPU's tokens and counts."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openai_whisper_coreml_tpu_torch import speculative

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2, n_audio_ctx=64)
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(3, 64, cfg.n_audio_state, generator=g)
    prompt = torch.randint(0, cfg.timestamp_begin, (3, 6), generator=g)
    verify = torch.randint(0, cfg.timestamp_begin, (3, 5), generator=g)
    pos = torch.tensor([6, 9, 14])
    # bf16: logits of magnitude 2-4 have an ulp of 1/64, and the card and
    # the CPU sum the step's products in other orders (a few ulps at most,
    # under one on average)
    for dtype, atol, mean in ((torch.bfloat16, 6.25e-2, 1e-2), (torch.float32, 1e-4, 1e-5)):
        cpu = build_model(cfg, dtype=dtype, seed=0, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        logits = {}
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            dev = model.device
            cross = dec_mod.precompute_cross_kv_int8(model.decoder,
                                                     feats.to(dev, dtype))
            cache = dec_mod.init_kv_cache(cfg, 3, dtype, dev, ctx=16)
            dec_mod.decode_step(model.decoder, prompt.to(dev), cross, cache, 0,
                                valid_from=1)
            before = (ss.launches, si.launches)
            step, _ = dec_mod.decode_step(
                model.decoder, verify[:, :1].to(dev), cross, cache, pos.to(dev),
                valid_from=1, self_kernel=dtype == torch.bfloat16)
            launched = (ss.launches - before[0], si.launches - before[1])
            if dev.type == "cuda":
                want = (cfg.n_text_layer if dtype == torch.bfloat16 else 0,
                        cfg.n_text_layer)
                assert launched == want
            before = (ss.launches, si.launches)
            out, _ = dec_mod.decode_step(model.decoder, verify.to(dev), cross,
                                         cache, pos.to(dev) + 1, valid_from=1)
            assert (ss.launches, si.launches) == before  # the verify step: none
            logits[name] = (step.float().cpu(), out.float().cpu(),
                            [c.float().cpu() for c in cache])
        for what, ours, ref in zip(("draft step", "verify step"), logits["cuda"][:2],
                                   logits["cpu"][:2]):
            err = (ours - ref).abs()
            print(f"{dtype} {what}: max {err.max().item():.4g}, "
                  f"mean {err.mean().item():.4g}")
            assert err.max().item() <= atol and err.mean().item() <= mean
        for ours, ref in zip(logits["cuda"][2], logits["cpu"][2]):
            assert (ours - ref).abs().max().item() <= atol
    # fp32 speculative greedy: the card's tokens and counts are the CPU's
    cpu = build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    draft = build_model(cfg, dtype=torch.float32, seed=1, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        t, d = (cpu, draft) if dev == "cpu" else (copy.deepcopy(cpu).to(dev),
                                                  copy.deepcopy(draft).to(dev))
        x = feats.to(dev)
        toks = torch.full((3, 4), cfg.eot_token)
        toks[:, 0] = cfg.sot_token
        mask = torch.zeros(cfg.n_vocab, dtype=torch.bool, device=dev)
        out = speculative.spec_decode_core(
            t.decoder, d.decoder, x, x, toks.to(dev), mask, mask, 50, 0, 0,
            sample_len=40, use_timestamps=True, prompt_len=4, spec_k=3,
            kv_dtype="int8")
        outs[dev] = [o.cpu() for o in out]
    for i in (0, 2, 4, 5):
        assert torch.equal(outs["cuda"][i], outs["cpu"][i])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["quantize_kv_column", "quantize_linear", "ieee_div"])
def test_quantizers_are_bit_equal_on_card_and_cpu(which):
    """int8 codes and fp32 scales are the same bits on the card as on the
    CPU at the model's shapes (large-v3 cross-KV columns, a 1280 x 1280
    weight): every Python-number division goes through one IEEE division."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    rng = np.random.default_rng(7)
    if which == "quantize_kv_column":
        x = rng.standard_normal((4, 20, 64, 1500)).astype(np.float32)
        fn = dec_mod.quantize_kv_column
    elif which == "quantize_linear":
        x = (0.02 * rng.standard_normal((1280, 1280))).astype(np.float32)
        fn = lambda w: tuple(tq.quantize_linear(w).values())  # noqa: E731
    else:
        x = (4 * rng.standard_normal((1280, 1280))).astype(np.float32)
        fn = lambda t: (tq.ieee_div(t.abs().amax(dim=-2, keepdim=True), 127.0),  # noqa: E731
                        tq.ieee_div(5.0 + t, 6.0), tq.ieee_div(127.0, t))
    cpu = fn(torch.from_numpy(x))
    card = fn(torch.from_numpy(x).cuda())
    for a, b in zip(cpu, card, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_evaluate_on_card_equals_cpu(tmp_path):
    """`evaluate` of a tiny fp32 model (head dim 64) over a three-utterance
    flat corpus on the card: the hypotheses and error counts the CPU's,
    with the frontend (K4) and the encoder (K1) launched on the way."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from openai_whisper_coreml_tpu_torch.eval.harness import evaluate
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(0)
    for i in range(3):
        t = np.arange(int((2 + i) * 16000)) / 16000
        x = (0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t)
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
        save_wav(str(tmp_path / f"utt{i}.wav"), x, 16000)
        (tmp_path / f"utt{i}.txt").write_text(f"reference text {i}")
    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    cpu = build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    kw = dict(batch_size=2, language="en", no_speech_threshold=None,
              logprob_threshold=None, compression_ratio_threshold=None,
              temperature=(0.0,), sample_len=16)
    reports = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        before = (fa.launches, mk.launches)
        report = evaluate(model, str(tmp_path), **kw)
        if name == "card":
            assert fa.launches > before[0] and mk.launches > before[1]
        assert report.pop("wall_seconds") >= 0 and report.pop("rtfx") > 0
        reports[name] = report
    assert reports["card"] == reports["cpu"]
    assert [e["id"] for e in reports["card"]["examples"]] == [
        "utt0.wav", "utt1.wav", "utt2.wav"]


@pytest.mark.cuda
def test_device_trace_records_the_flash_kernel_on_card(tmp_path):
    """A device trace around a bf16 encode on the card holds the flash
    kernel's launches as CUDA kernel events, and the annotated region."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import glob
    import json

    from openai_whisper_coreml_tpu_torch.utils.profiling import annotate, device_trace

    model = build_model(tiny_test_config(n_state=128, n_head=2, n_layer=2),
                        dtype=torch.bfloat16, seed=0, device="cuda")
    audio = (np.random.default_rng(1).standard_normal((1, 480_000)) * 0.1
             ).astype(np.float32)
    before = fa.launches
    with device_trace(str(tmp_path)):
        with annotate("encode_window"):
            model.encode(model.log_mel(audio))
    assert fa.launches - before == 2
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    # csrc/flash_attention.cu's fa_fwd_bf16_kernel, csrc/mel.cu's log_mel_kernel
    assert sum("fa_fwd_bf16_kernel" in k for k in kernels) == 2, sorted(set(kernels))
    assert any("log_mel_kernel" in k for k in kernels), sorted(set(kernels))
    assert any(e.get("name") == "encode_window" for e in events)
