"""Checkpoint save/load (port of `utils/checkpoint.py`).

Parameter checkpoints are flat safetensors files whose keys are the
"/"-joined paths of the JAX parameter tree (`decoder/blocks/attn/q/w`,
layers stacked on axis 0), with the JAX package's JSON metadata:
`format: whisper-tpu-v1`, the model name, and `quantized: int8` when the
tree holds int8 `w_q` leaves. `save_params` stores bf16 as fp32. The files
are written and read here by hand (an 8-byte little-endian header length,
a JSON header with `__metadata__` and each tensor's dtype, shape and byte
range, then the raw little-endian bytes), so no `safetensors` package is
needed; the JAX package's `save_params` / `load_params` read and write the
same files. The reader and writer also take BF16 tensors (HF and
fine-tuned checkpoints come in bf16): numpy has no bf16, so their bytes
travel as 16-bit integers and come back as `torch.bfloat16` tensors.

Training state for an exact resume (`save_train_state`) is a directory
holding one `torch.save` file of {params tree, optimizer state (moments,
update count and the gradient-accumulation window), step}. JAX writes
orbax directories there instead: the two do not interchange.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

FORMAT = "whisper-tpu-v1"
STATE_FILE = "train_state.pt"

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
BF16 = "BF16"


def flatten_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested tree -> {"a/b/c": leaf}; leaves are kept as they are."""
    out: Dict[str, Any] = {}
    for key, val in params.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, Mapping):
            out.update(flatten_params(val, path))
        else:
            out[path] = val
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Params:
    tree: Params = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_numpy(x) -> np.ndarray:
    """A leaf as numpy; bf16 (which numpy lacks) becomes fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _st_array(name: str, x) -> Tuple[str, np.ndarray]:
    """(safetensors dtype name, little-endian contiguous array) of a numpy
    array or a tensor; a bf16 tensor's bits as int16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return BF16, x.view(torch.int16).numpy().astype("<i2", copy=False)
        x = x.numpy()
    a = np.ascontiguousarray(x)
    a = a.astype(a.dtype.newbyteorder("<"), copy=False)
    if a.dtype not in _ST_NAMES:
        raise TypeError(f"{name}: dtype {a.dtype} has no safetensors name")
    return _ST_NAMES[a.dtype], a


def write_safetensors(path: str, tensors: Mapping[str, Any],
                      metadata: Mapping[str, str]) -> None:
    """Write a safetensors file of numpy arrays or tensors (bf16 ones as
    BF16): header length (u64 LE), JSON header padded with spaces to 8
    bytes, then each tensor's little-endian bytes in header order."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata)}
    arrays = []
    offset = 0
    for name in sorted(tensors):
        dtype, a = _st_array(name, tensors[name])
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays:
            f.write(memoryview(a).cast("B"))
    os.replace(tmp, path)


def _read_header(f) -> Tuple[int, Dict[str, Any]]:
    (n,) = struct.unpack("<Q", f.read(8))
    return 8 + n, json.loads(f.read(n))


def read_safetensors(path: str) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """(name -> numpy array, metadata) of a safetensors file; BF16 tensors
    come back as `torch.bfloat16` tensors (numpy has no bf16)."""
    with open(path, "rb") as f:
        start, header = _read_header(f)
    meta = header.pop("__metadata__", None) or {}
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=start)
    out: Dict[str, Any] = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        if info["dtype"] == BF16:
            bits = np.array(data[lo:hi].view("<i2")).reshape(info["shape"])
            out[name] = torch.from_numpy(bits).view(torch.bfloat16)
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which "
                             f"the reader does not take")
        dtype = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = np.array(data[lo:hi].view(dtype)).reshape(info["shape"])
    return out, meta


def save_params(params, path: str, *, model_name: str = "",
                extra_meta: Optional[Mapping[str, str]] = None) -> None:
    """Save a parameter tree (tensors or numpy) or a WhisperModel's
    parameters (in the JAX layout, `params.params_tree`)."""
    if isinstance(params, torch.nn.Module):
        from ..params import params_tree

        params = params_tree(params)
    flat = {k: _to_numpy(v) for k, v in flatten_params(params).items()}
    meta = {"format": FORMAT, "model": model_name}
    if any(k.endswith("/w_q") for k in flat):
        # int8 serving checkpoint: loaders keep w_q int8 and skip
        # re-quantization
        meta["quantized"] = "int8"
    meta.update(extra_meta or {})
    write_safetensors(path, flat, meta)


def read_metadata(path: str) -> Dict[str, str]:
    """The JSON metadata of a whisper-tpu safetensors file."""
    with open(path, "rb") as f:
        _, header = _read_header(f)
    return dict(header.get("__metadata__") or {})


def load_params(path: str, *, cfg=None, dtype: torch.dtype = torch.float32) -> Params:
    """Load a checkpoint written by `save_params` (either package's) as a
    tree of CPU tensors. `w_q` stays int8 and the `scale` paired with it
    stays fp32 whatever `dtype` asks; every other leaf (layer-norm scales
    included) becomes `dtype`."""
    raw, _ = read_safetensors(path)
    flat = {}
    for k, v in raw.items():
        t = torch.as_tensor(v)
        if k.endswith("/w_q"):
            flat[k] = t.to(torch.int8)
        elif k.endswith("/scale") and k[: -len("scale")] + "w_q" in raw:
            flat[k] = t.float()
        else:
            flat[k] = t.to(dtype)
    params = unflatten_params(flat)
    if cfg is not None:
        _validate_shapes(params, cfg)
    return params


def _validate_shapes(params: Params, cfg) -> None:
    emb = params["decoder"]["token_embedding"]
    if tuple(emb.shape) != (cfg.n_vocab, cfg.n_text_state):
        raise ValueError(
            f"checkpoint/config mismatch: token_embedding {tuple(emb.shape)} != "
            f"({cfg.n_vocab}, {cfg.n_text_state}) for model {cfg.name!r}")
    q = params["decoder"]["blocks"]["attn"]["q"]
    n_layers = (q["w"] if "w" in q else q["w_q"]).shape[0]
    if n_layers != cfg.n_text_layer:
        raise ValueError(
            f"checkpoint has {n_layers} decoder layers, config expects "
            f"{cfg.n_text_layer}")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Mapping):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def save_train_state(path: str, model, opt_state=None,
                     step: Optional[int] = None) -> None:
    """Full training state for an exact resume, in directory `path`: the
    model's parameter tree (JAX layout, dtypes kept; `model` may be the
    tree itself, as a sharded run passes its gathered tree), the optimizer state
    (`train.Optimizer`: moments, update count, accumulation window) and the
    completed step count, as one `torch.save` file. Not an orbax
    directory: JAX's train-state directories and these do not interchange."""
    from ..params import params_tree

    os.makedirs(path, exist_ok=True)
    tree = params_tree(model) if isinstance(model, torch.nn.Module) else model
    state = {"params": _to_cpu(tree)}
    if opt_state is not None:
        state["opt_state"] = _to_cpu(opt_state)
    if step is not None:
        state["step"] = int(step)
    file = os.path.join(path, STATE_FILE)
    tmp = f"{file}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, file)


def restore_train_state(path: str, map_location=None) -> Dict[str, Any]:
    """Read what `save_train_state` wrote: {"params", "opt_state", "step"}."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)
