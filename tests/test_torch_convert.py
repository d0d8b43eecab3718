"""Port checkpoint conversion (`params.params_from_*_state_dict`,
`convert.py`, the BF16 safetensors path) against the JAX package's
converters and `tools/convert.py`.

State dicts are built here from random weights at a tiny config, in the
openai layout (`{"dims", "model_state_dict"}` saved with `torch.save`) and
the HF layout (a directory with `model.safetensors`, a two-shard index,
`pytorch_model.bin` and `generation_config.json`), in fp32, fp16 and bf16.
Both converters run on each; every leaf and the metadata must be equal,
both packages must read the files, and the HF alignment heads must reach
`model.alignment_heads`. One conversion runs in a process where importing
jax or safetensors fails."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import config as jconfig
from openai_whisper_coreml_tpu import params as jparams
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import load_model as jax_load_model
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.utils import checkpoint as jckpt
from openai_whisper_coreml_tpu_torch import config as tconfig
from openai_whisper_coreml_tpu_torch import convert as tconvert
from openai_whisper_coreml_tpu_torch import params as tparams
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.whisper import load_model
from openai_whisper_coreml_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(n_state=128, n_head=2, n_layer=2)  # wide enough that int8 takes the MLPs
NAME = "convert-test"
DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}
# three pairs: two would read as a (2, 2) mask, in both packages (a fault
# shared with the reference: load_alignment_heads tests the mask shape first)
HEADS = [[0, 1], [1, 0], [1, 1]]


def _jax_convert_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_tool", os.path.join(ROOT, "tools", "convert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _test_config(monkeypatch):
    monkeypatch.setitem(tconfig.CONFIGS, NAME, tiny_test_config(**SIZE))
    monkeypatch.setitem(jconfig.CONFIGS, NAME, jax_tiny(**SIZE))


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jax_init(jax_tiny(**SIZE), jax.random.PRNGKey(3)))


def _linear_sd(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].T
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _ln_sd(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]


def openai_state_dict(tree, dtype):
    """The openai/whisper names of a JAX-layout tree."""
    sd = {}
    names = {"q": "query", "k": "key", "v": "value", "out": "out"}
    for side in ("encoder", "decoder"):
        blocks = tree[side]["blocks"]
        for i in range(blocks["attn"]["q"]["w"].shape[0]):
            layer = jax.tree.map(lambda x: x[i], blocks)
            pre = f"{side}.blocks.{i}"
            for att in ("attn", "cross_attn") if side == "decoder" else ("attn",):
                for k, n in names.items():
                    _linear_sd(sd, f"{pre}.{att}.{n}", layer[att][k])
                _ln_sd(sd, f"{pre}.{att}_ln", layer[f"{att}_ln"])
            _linear_sd(sd, f"{pre}.mlp.0", layer["mlp"]["fc1"])
            _linear_sd(sd, f"{pre}.mlp.2", layer["mlp"]["fc2"])
            _ln_sd(sd, f"{pre}.mlp_ln", layer["mlp_ln"])
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = tree["encoder"][conv]["w"].transpose(2, 1, 0)
        sd[f"encoder.{conv}.bias"] = tree["encoder"][conv]["b"]
    _ln_sd(sd, "encoder.ln_post", tree["encoder"]["ln_post"])
    sd["decoder.token_embedding.weight"] = tree["decoder"]["token_embedding"]
    sd["decoder.positional_embedding"] = tree["decoder"]["positional_embedding"]
    _ln_sd(sd, "decoder.ln", tree["decoder"]["ln"])
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()}


def hf_state_dict(tree, dtype):
    """The HuggingFace WhisperForConditionalGeneration names of a tree
    (with the keys HF has and the converters skip)."""
    sd = {}
    names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
    for side in ("encoder", "decoder"):
        blocks = tree[side]["blocks"]
        for i in range(blocks["attn"]["q"]["w"].shape[0]):
            layer = jax.tree.map(lambda x: x[i], blocks)
            pre = f"model.{side}.layers.{i}"
            atts = {"attn": "self_attn"}
            if side == "decoder":
                atts["cross_attn"] = "encoder_attn"
            for att, hf in atts.items():
                for k, n in names.items():
                    _linear_sd(sd, f"{pre}.{hf}.{n}", layer[att][k])
                _ln_sd(sd, f"{pre}.{hf}_layer_norm", layer[f"{att}_ln"])
            _linear_sd(sd, f"{pre}.fc1", layer["mlp"]["fc1"])
            _linear_sd(sd, f"{pre}.fc2", layer["mlp"]["fc2"])
            _ln_sd(sd, f"{pre}.final_layer_norm", layer["mlp_ln"])
    for conv in ("conv1", "conv2"):
        sd[f"model.encoder.{conv}.weight"] = tree["encoder"][conv]["w"].transpose(2, 1, 0)
        sd[f"model.encoder.{conv}.bias"] = tree["encoder"][conv]["b"]
    _ln_sd(sd, "model.encoder.layer_norm", tree["encoder"]["ln_post"])
    sd["model.encoder.embed_positions.weight"] = np.zeros((1500, SIZE["n_state"]),
                                                          np.float32)
    sd["model.decoder.embed_tokens.weight"] = tree["decoder"]["token_embedding"]
    sd["model.decoder.embed_positions.weight"] = tree["decoder"]["positional_embedding"]
    _ln_sd(sd, "model.decoder.layer_norm", tree["decoder"]["ln"])
    sd["proj_out.weight"] = tree["decoder"]["token_embedding"]
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()}


def write_input(tmp_path, layout, tree, dtype):
    """A checkpoint in one layout: the path to pass as --input."""
    if layout == "openai":
        path = str(tmp_path / "model.pt")
        torch.save({"dims": {"n_audio_state": SIZE["n_state"]},
                    "model_state_dict": openai_state_dict(tree, dtype)}, path)
        return path
    d = tmp_path / layout
    d.mkdir()
    sd = hf_state_dict(tree, dtype)
    if layout == "hf":
        tckpt.write_safetensors(str(d / "model.safetensors"), sd, {"format": "pt"})
    elif layout == "hf-sharded":
        keys = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": keys[::2],
                  "model-00002-of-00002.safetensors": keys[1::2]}
        for shard, ks in shards.items():
            tckpt.write_safetensors(str(d / shard), {k: sd[k] for k in ks},
                                    {"format": "pt"})
        with open(d / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": {k: s for s, ks in shards.items()
                                                      for k in ks}}, f)
    else:  # hf-bin
        torch.save(sd, str(d / "pytorch_model.bin"))
    with open(d / "generation_config.json", "w") as f:
        json.dump({"alignment_heads": HEADS, "max_length": 448}, f)
    return str(d)


def _assert_files_equal(ours, ref):
    a, meta_a = tckpt.read_safetensors(ours)
    b, meta_b = tckpt.read_safetensors(ref)
    assert meta_a == meta_b and set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["openai", "hf", "hf-sharded", "hf-bin"])
def test_convert_matches_jax_tool(tree, tmp_path, layout, dtype):
    """Both tools on one input: the same file, leaf for leaf and metadata;
    both packages load it; HF heads reach model.alignment_heads."""
    src = write_input(tmp_path, layout, tree, DTYPES[dtype])
    ours, ref = str(tmp_path / "ours.safetensors"), str(tmp_path / "ref.safetensors")
    args = ["--input", src, "--model", NAME]
    assert tconvert.main(args + ["--output", ours]) == 0
    assert _jax_convert_tool().main(args + ["--output", ref]) == 0
    _assert_files_equal(ours, ref)
    meta = tckpt.read_metadata(ours)
    assert meta == jckpt.read_metadata(ours)
    assert meta["format"] == "whisper-tpu-v1" and meta["model"] == NAME
    assert meta["source_format"] == ("openai" if layout == "openai" else "hf")
    assert meta["dtype"] == "float32" and "quantized" not in meta
    model = load_model(NAME, checkpoint=ours, device="cpu")
    leaves = tckpt.flatten_params(tparams.to_jax_params(model))
    raw, _ = tckpt.read_safetensors(ours)
    assert set(leaves) == set(raw)
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, raw[k], err_msg=k)
    if dtype == "fp32":
        for k, v in tckpt.flatten_params(tree).items():
            np.testing.assert_array_equal(raw[k], v, err_msg=k)
    jax_model = jax_load_model(NAME, checkpoint=ours)
    if layout == "openai":
        assert model.alignment_heads is None and jax_model.alignment_heads is None
    else:
        want = np.array([[False, True], [True, True]])
        np.testing.assert_array_equal(model.alignment_heads, want)
        np.testing.assert_array_equal(jax_model.alignment_heads, want)


@pytest.mark.parametrize("layout", ["openai", "hf"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_params_from_state_dict_leaves_equal_jax(tree, layout, dtype):
    """The converters themselves, in fp32 and bf16 output: every leaf
    equals the JAX converter's."""
    sd = (openai_state_dict if layout == "openai" else hf_state_dict)(tree, DTYPES[dtype])
    ours_fn = getattr(tparams, f"params_from_{layout}_state_dict")
    ref_fn = getattr(jparams, f"params_from_{layout}_state_dict")
    for out, jout in ((torch.float32, jax.numpy.float32),
                      (torch.bfloat16, jax.numpy.bfloat16)):
        ours = tckpt.flatten_params(ours_fn(tiny_test_config(**SIZE), sd, dtype=out))
        ref = jckpt.flatten_params(ref_fn(jax_tiny(**SIZE), sd, dtype=jout))
        assert set(ours) == set(ref)
        for k, v in ours.items():
            assert v.dtype == out and v.is_contiguous(), k
            np.testing.assert_array_equal(v.float().numpy(),
                                          ref[k].astype(np.float32), err_msg=k)


@pytest.mark.parametrize("extra", [["--dtype", "bfloat16"], ["--quantize", "int8"],
                                   ["--dtype", "bfloat16", "--quantize", "int8"]])
def test_convert_options_and_native_reconvert_match_jax(tree, tmp_path, extra):
    """--dtype bfloat16 and --quantize int8 from an HF directory, then a
    native re-convert of a float file to int8 (the heads carried along):
    the same files as JAX's tool writes."""
    src = write_input(tmp_path, "hf", tree, torch.bfloat16)
    tool = _jax_convert_tool()
    ours, ref = str(tmp_path / "ours.safetensors"), str(tmp_path / "ref.safetensors")
    args = ["--input", src, "--model", NAME] + extra
    assert tconvert.main(args + ["--output", ours]) == 0
    assert tool.main(args + ["--output", ref]) == 0
    _assert_files_equal(ours, ref)
    if "--quantize" in extra:
        assert tckpt.read_metadata(ours)["quantized"] == "int8"
        with pytest.raises(SystemExit, match="already an int8"):
            tconvert.main(["--input", ours, "--output", str(tmp_path / "x.safetensors")])
        return
    again = [str(tmp_path / "ours8.safetensors"), str(tmp_path / "ref8.safetensors")]
    assert tconvert.main(["--input", ours, "--quantize", "int8", "--output", again[0]]) == 0
    assert tool.main(["--input", ours, "--quantize", "int8", "--output", again[1]]) == 0
    _assert_files_equal(*again)
    meta = tckpt.read_metadata(again[0])
    assert meta["source_format"] == "native" and json.loads(meta["alignment_heads"]) == HEADS
    model = load_model(NAME, checkpoint=again[0], quantize="int8", device="cpu")
    assert model.alignment_heads.sum() == 3


def test_model_name_detection_matches_jax(tmp_path):
    """openai dims name the model (large-v3-turbo by its decoder depth);
    --model may not contradict them (but for large-v1 / large-v2)."""
    tool = _jax_convert_tool()
    cases = [((384, 4, 80, 51865), 4, "tiny"), ((1280, 32, 128, 51866), 32, "large-v3"),
             ((1280, 32, 128, 51866), 4, "large-v3-turbo"),
             ((1280, 32, 80, 51865), 32, "large-v2"), ((999, 1, 80, 1), 1, None)]
    for (state, layers, mels, vocab), text_layers, want in cases:
        path = str(tmp_path / f"{state}-{layers}-{text_layers}.pt")
        torch.save({"dims": {"n_audio_state": state, "n_audio_layer": layers,
                             "n_mels": mels, "n_vocab": vocab,
                             "n_text_layer": text_layers},
                    "model_state_dict": {}}, path)
        assert tconvert.load_state_dict(path)[1:] == (want, "openai")
        assert tool.load_state_dict(path)[1:] == (want, "openai")
    with pytest.raises(SystemExit, match="contradicts"):
        tconvert.main(["--input", str(tmp_path / "384-4-4.pt"),
                       "--model", "base", "--output", str(tmp_path / "x.safetensors")])
    with pytest.raises(SystemExit, match="auto-detect"):
        tconvert.main(["--input", str(tmp_path / "999-1-1.pt"),
                       "--output", str(tmp_path / "x.safetensors")])


def test_bf16_round_trips_through_reader_and_writer(tmp_path):
    """BF16 tensors are written as BF16 (2 bytes each) and read back bit for
    bit as torch.bfloat16; the safetensors package reads the same bits; other
    dtypes stay numpy; save_params still stores bf16 leaves as fp32."""
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "b": np.arange(6, dtype=np.float16).reshape(2, 3),
               "c": torch.tensor([-0.0, float("inf"), 1e-40]).to(torch.bfloat16),
               "d": np.arange(4, dtype=np.int8)}
    path = str(tmp_path / "t.safetensors")
    tckpt.write_safetensors(path, tensors, {"k": "v"})
    back, meta = tckpt.read_safetensors(path)
    assert meta == {"k": "v"}
    for k in ("a", "c"):
        assert back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16), tensors[k].view(torch.int16))
    for k in ("b", "d"):
        assert back[k].dtype == tensors[k].dtype
        np.testing.assert_array_equal(back[k], tensors[k])
    lib = load_file(path)
    assert torch.equal(lib["a"].view(torch.int16), tensors["a"].view(torch.int16))
    with open(path, "rb") as f:
        header = tckpt._read_header(f)[1]
    assert header["a"]["dtype"] == "BF16" and header["b"]["dtype"] == "F16"
    lo, hi = header["a"]["data_offsets"]
    assert hi - lo == 2 * 15
    tckpt.save_params({"x": {"w": tensors["a"]}}, str(tmp_path / "p.safetensors"))
    raw, _ = tckpt.read_safetensors(str(tmp_path / "p.safetensors"))
    assert raw["x/w"].dtype == np.float32


def test_convert_runs_without_jax_or_safetensors(tree, tmp_path):
    """An HF directory in bf16 converts, and the file loads with its heads,
    in a process where importing jax or safetensors raises ImportError."""
    src = write_input(tmp_path, "hf-sharded", tree, torch.bfloat16)
    out = str(tmp_path / "o.safetensors")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'safetensors', 'openai_whisper_coreml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from openai_whisper_coreml_tpu_torch import config, convert\n"
        "from openai_whisper_coreml_tpu_torch.models.whisper import load_model\n"
        f"config.CONFIGS[{NAME!r}] = config.tiny_test_config(**{SIZE!r})\n"
        f"assert convert.main(['--input', {src!r}, '--model', {NAME!r}, "
        f"'--output', {out!r}]) == 0\n"
        f"m = load_model({NAME!r}, checkpoint={out!r}, device='cpu')\n"
        "assert int(m.alignment_heads.sum()) == 3\n"
        "assert not any(k.split('.')[0] in ('jax', 'safetensors') "
        "for k, v in sys.modules.items() if v is not None)\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = str(tmp_path / "ref.safetensors")
    assert _jax_convert_tool().main(["--input", src, "--model", NAME,
                                     "--output", ref]) == 0
    _assert_files_equal(out, ref)
