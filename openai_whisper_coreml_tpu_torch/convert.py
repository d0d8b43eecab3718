"""Convert public Whisper checkpoints to `.safetensors` files both packages
load (port of `tools/convert.py`; needs no JAX and no `safetensors`
package):

  python -m openai_whisper_coreml_tpu_torch.convert --input small.pt \\
      --output ckpts/small.safetensors
  python -m openai_whisper_coreml_tpu_torch.convert --input hf/whisper-small \\
      --model small --output ckpts/small.safetensors [--quantize int8]

Inputs:
  * openai/whisper `.pt` files (a dict with "dims" and "model_state_dict"),
    read with `torch.load(weights_only=True)`;
  * HuggingFace directories: `model.safetensors`, a sharded
    `model.safetensors.index.json`, or `pytorch_model.bin`, in fp32, fp16
    or bf16; `generation_config.json`'s `alignment_heads` go into the
    output's metadata, where `load_model` reads them;
  * this format's own float files (`format: whisper-tpu-v1`), to write
    them again, e.g. as int8 serving checkpoints.

`.safetensors` inputs are read by the port's own reader
(`utils.checkpoint.read_safetensors`). The output's metadata is the JAX
package's: `format`, `model`, `source_format`, `dtype`, and `quantized`
when int8.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Tuple

import torch

from .utils.checkpoint import FORMAT, read_metadata, read_safetensors

_DIMS_TO_NAME = {
    # (n_audio_state, n_audio_layer, n_mels, n_vocab) -> model name
    (384, 4, 80, 51865): "tiny",
    (384, 4, 80, 51864): "tiny.en",
    (512, 6, 80, 51865): "base",
    (512, 6, 80, 51864): "base.en",
    (768, 12, 80, 51865): "small",
    (768, 12, 80, 51864): "small.en",
    (1024, 24, 80, 51865): "medium",
    (1024, 24, 80, 51864): "medium.en",
    (1280, 32, 80, 51865): "large-v2",
    (1280, 32, 128, 51866): "large-v3",
}


def _read_hf_dir(path: str) -> Dict[str, Any]:
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)[0]
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        # a sharded save_pretrained: every shard the index names
        with open(index, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
        sd: Dict[str, Any] = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(read_safetensors(os.path.join(path, shard))[0])
        return sd
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights found under {path}")


def load_state_dict(path: str) -> Tuple[Any, Optional[str], str]:
    """(state dict, or the metadata of a native file; the model name the
    file's dims give, or None; "openai", "hf" or "native")."""
    if os.path.isdir(path):
        return _read_hf_dir(path), None, "hf"
    if path.endswith(".safetensors"):
        meta = read_metadata(path)
        if meta.get("format") == FORMAT:
            return meta, meta.get("model") or None, "native"
        sd = read_safetensors(path)[0]
        fmt = "hf" if any(k.startswith(("model.", "proj_out.", "encoder.layers"))
                          for k in sd) else "openai"
        return sd, None, fmt
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        dims = obj.get("dims", {})
        name = _DIMS_TO_NAME.get((dims.get("n_audio_state"), dims.get("n_audio_layer"),
                                  dims.get("n_mels"), dims.get("n_vocab")))
        # large-v3-turbo: large-v3's dims but for the decoder's depth
        if name == "large-v3" and dims.get("n_text_layer") == 4:
            name = "large-v3-turbo"
        # large-v1 and large-v2 share every dims field: "large-v2" unless
        # --model says large-v1
        return obj["model_state_dict"], name, "openai"
    return obj, None, "openai"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True,
                    help=".pt / .safetensors file or HF checkpoint dir")
    ap.add_argument("--model", default=None,
                    help="model size name (auto-detected for openai .pt)")
    ap.add_argument("--output", required=True, help="output .safetensors path")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--quantize", choices=("int8",), default=None,
                    help="write an int8 serving checkpoint (w_q + per-channel "
                         "scales)")
    args = ap.parse_args(argv)

    from .config import get_config
    from .params import params_from_hf_state_dict, params_from_openai_state_dict
    from .quantize import quantize_params
    from .utils.checkpoint import flatten_params, load_params, save_params

    sd, detected, fmt = load_state_dict(args.input)
    name = args.model or detected
    if name is None:
        raise SystemExit("could not auto-detect model size; pass --model")
    if detected and args.model and args.model != detected:
        # large-v1/v2 share dims; any other pair would truncate layers or
        # mislabel the checkpoint
        allowed = {detected, "large-v1" if detected == "large-v2" else detected}
        if args.model not in allowed:
            raise SystemExit(
                f"--model {args.model!r} contradicts the checkpoint's detected "
                f"size {detected!r}; converting would truncate or mislabel "
                f"weights (drop --model to use the detected size)")
    cfg = get_config(name)
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16

    if fmt == "native":
        if sd.get("quantized"):
            raise SystemExit(f"{args.input} is already an int8 serving checkpoint; "
                             "re-convert from the float checkpoint instead")
        params = load_params(args.input, cfg=cfg, dtype=dtype)
    elif fmt == "hf":
        params = params_from_hf_state_dict(cfg, sd, dtype=dtype)
    else:
        params = params_from_openai_state_dict(cfg, sd, dtype=dtype)

    extra = {"source_format": fmt, "dtype": args.dtype}
    if fmt == "native" and sd.get("alignment_heads"):
        extra["alignment_heads"] = sd["alignment_heads"]
    # HF checkpoints ship each model's alignment heads (word-timestamp
    # quality) in generation_config.json
    if os.path.isdir(args.input):
        gc_path = os.path.join(args.input, "generation_config.json")
        if os.path.exists(gc_path):
            with open(gc_path, encoding="utf-8") as f:
                gc = json.load(f)
            if gc.get("alignment_heads"):
                extra["alignment_heads"] = json.dumps(gc["alignment_heads"])

    if args.quantize == "int8":
        params = quantize_params(params)

    save_params(params, args.output, model_name=name, extra_meta=extra)
    n = sum(t.numel() for t in flatten_params(params).values())
    print(f"wrote {args.output}: {name} ({n / 1e6:.1f}M params, {fmt} source"
          + (", int8-quantized" if args.quantize else "") + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
