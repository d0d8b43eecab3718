"""The fused linear's dispatch rule (`models.layers.takes_fused`), its
plain version and its wrapper's checks, on the CPU.

A bf16 linear on the card over at least `FUSED_MIN_ROWS` rows, with no
LoRA adapters and no gradient to keep, runs as one `ops.fused_linear`
launch; every other call keeps the product and the epilogue apart. The
rule reads only what the call can observe, so stand-in tensors that say
they lie on the card exercise it here. The kernel itself is held to its
plain version on the card (`tests/test_torch_kernels_cuda.py`)."""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch.models import layers
from openai_whisper_coreml_tpu_torch.models.layers import Linear, linear, takes_fused
from openai_whisper_coreml_tpu_torch.ops import fused_linear as fl
from openai_whisper_coreml_tpu_torch.utils import profiling

K, N = 64, 48
ROWS = layers.FUSED_MIN_ROWS


def _leaves(kind: str, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    p = {}
    if kind == "int8":
        p["w_q"] = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
        p["scale"] = 0.01 * (1 + torch.rand(1, N, generator=g))
    else:
        p["w"] = torch.randn(K, N, generator=g).bfloat16()
    p["b"] = torch.randn(N, generator=g).bfloat16()
    if kind == "lora":
        p["lora_a"] = torch.randn(K, 4, generator=g).bfloat16()
        p["lora_b"] = torch.randn(4, N, generator=g).bfloat16()
    return p


def _on_card(rows: int, dtype=torch.bfloat16, requires_grad: bool = False, k: int = K):
    """What `takes_fused` reads of a (rows, k) activation on the card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(rows, k),
                                 requires_grad=requires_grad, numel=lambda: rows * k)


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize("rows", [ROWS, 1500, 96_000])
def test_bf16_linears_over_many_rows_on_the_card_take_the_kernel(kind, rows):
    assert takes_fused(_on_card(rows), Linear(_leaves(kind)))


@pytest.mark.parametrize("rows", [1, 64, 128, ROWS - 1])
def test_fewer_rows_than_the_threshold_keep_the_plain_path(rows):
    assert not takes_fused(_on_card(rows), Linear(_leaves("int8")))


def test_the_threshold_admits_a_window_of_audio_frames_and_not_a_decode_step():
    assert 128 < layers.FUSED_MIN_ROWS <= 1500


def test_rows_count_every_leading_dim():
    x = _on_card(0)
    x.shape, x.numel = (4, ROWS // 4, K), (lambda: ROWS * K)
    assert takes_fused(x, Linear(_leaves("int8")))


def test_lora_keeps_the_plain_path():
    assert not takes_fused(_on_card(96_000), Linear(_leaves("lora")))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_other_dtypes_keep_the_plain_path(dtype):
    assert not takes_fused(_on_card(96_000, dtype), Linear(_leaves("float")))


def test_cpu_tensors_keep_the_plain_path():
    assert not takes_fused(torch.zeros(96_000, K, dtype=torch.bfloat16),
                           Linear(_leaves("int8")))


def test_widths_off_tma_rule_keep_the_plain_path():
    p = {"w": torch.zeros(K + 4, N, dtype=torch.bfloat16)}
    assert not takes_fused(_on_card(96_000, k=K + 4), Linear(p))


def test_a_product_autograd_needs_keeps_the_plain_path():
    x = _on_card(96_000, requires_grad=True)
    assert not takes_fused(x, Linear(_leaves("int8")))
    with torch.no_grad():
        assert takes_fused(x, Linear(_leaves("int8")))
    # a trained leaf: the weight or the bias needs its gradient
    for leaf in ("w", "b"):
        lin = Linear(_leaves("float"))
        getattr(lin, leaf).requires_grad_(True)
        assert not takes_fused(_on_card(96_000), lin)
        with torch.no_grad():
            assert takes_fused(_on_card(96_000), lin)


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_version_is_the_unfused_linear(kind, bias):
    """`fused_linear_reference` is the product and epilogue that `linear`
    runs apart, bit for bit, so the card test that holds the kernel to it
    holds it to the unfused path."""
    p = _leaves(kind, seed=3)
    if not bias:
        del p["b"]
    lin = Linear(p)
    x = torch.randn(5, 7, K, generator=torch.Generator().manual_seed(4)).bfloat16()
    w = lin.w if lin.w_q is None else lin.w_q.bfloat16()
    scale = None if lin.scale is None else lin.scale.reshape(-1)
    b = None if lin.b is None else lin.b.float()
    want = fl.fused_linear_reference(x.reshape(-1, K), w, scale, b)
    assert torch.equal(linear(x, lin).reshape(-1, N), want)
    # on the CPU the wrapper is the plain version and counts no launch
    before = fl.launches
    assert torch.equal(fl.fused_linear(x.reshape(-1, K), w, scale, b), want)
    assert fl.launches == before


def test_plain_version_rounds_once():
    """The scale and the bias are added to the fp32 product before the
    one cast: with a bias that cancels most of each output, a product
    rounded to bf16 first would move the result by many bf16 spacings."""
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.standard_normal((6, K)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(g.integers(-127, 128, (K, N)).astype(np.float32)).bfloat16()
    scale = torch.from_numpy((0.01 * (1 + g.random(N))).astype(np.float32))
    y = (x.double() @ w.double()) * scale.double()
    b = (-(1 - 2.0 ** -6) * y[0]).float()
    got = fl.fused_linear_reference(x, w, scale, b).double()
    exact = y + b.double()
    spacing = torch.exp2(torch.floor(torch.log2(exact.abs())) - 7)
    assert ((got - exact).abs() <= spacing).all()


def _args(m=32, k=K, n=N):
    return (torch.zeros(m, k, dtype=torch.bfloat16), torch.zeros(k, n, dtype=torch.bfloat16),
            torch.ones(n), torch.zeros(n))


@pytest.mark.parametrize("case,error,match", [
    ("x_fp32", TypeError, "bf16"),
    ("w_int8", TypeError, "bf16"),
    ("x_3d", ValueError, r"\(M, K\)"),
    ("k_mismatch", ValueError, r"\(M, K\)"),
    ("k_not_8", ValueError, "multiples of 8"),
    ("n_not_8", ValueError, "multiples of 8"),
    ("no_rows", ValueError, "M >= 1"),
    ("scale_shape", ValueError, "scale must be fp32"),
    ("bias_bf16", ValueError, "b must be fp32"),
    ("x_strided", ValueError, "contiguous"),
    ("w_transposed", ValueError, "contiguous"),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(case, error, match):
    x, w, scale, b = _args()
    if case == "x_fp32":
        x = x.float()
    elif case == "w_int8":
        w = w.to(torch.int8)
    elif case == "x_3d":
        x = x[None]
    elif case == "k_mismatch":
        w = torch.zeros(K + 8, N, dtype=torch.bfloat16)
    elif case == "k_not_8":
        x, w, scale, b = _args(k=K + 4)
    elif case == "n_not_8":
        x, w, scale, b = _args(n=N + 4)
    elif case == "no_rows":
        x = x[:0]
    elif case == "scale_shape":
        scale = scale[None]
    elif case == "bias_bf16":
        b = b.bfloat16()
    elif case == "x_strided":
        x = torch.zeros(32, 2 * K, dtype=torch.bfloat16)[:, :K]
    elif case == "w_transposed":
        w = torch.zeros(N, K, dtype=torch.bfloat16).T
    with pytest.raises(error, match=match):
        fl._check_cuda(x, w, scale, b)


def test_wrapper_checks_pass_what_the_kernel_takes():
    fl._check_cuda(*_args())
    x, w, _, _ = _args()
    fl._check_cuda(x, w, None, None)


def _span_names(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return [e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("kind", ["int8", "float"])
def test_fused_branch_is_its_own_span_and_the_unfused_result(kind, tmp_path):
    """The fused branch (`layers._fused`, which on the CPU runs the plain
    version) gives `linear`'s bits, and with spans on is one
    `linear.fused` span (after the int8 weight's `linear.weight_cast`),
    with no `linear.epilogue`."""
    lin = Linear(_leaves(kind, seed=6))
    x = torch.randn(3, 5, K, generator=torch.Generator().manual_seed(7)).bfloat16()
    assert torch.equal(layers._fused(x, lin), linear(x, lin))
    with profiling.device_trace(str(tmp_path)):
        layers._fused(x, lin)
    names = _span_names(str(tmp_path))
    assert names.count("linear.fused") == 1 and "linear.epilogue" not in names
    assert names.count("linear.weight_cast") == (kind == "int8")
