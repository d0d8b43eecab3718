"""Rank workers for the port's DP x TP tests (`test_torch_parallel*.py`).

Each test spawns gloo ranks on the CPU over a `file://` store and runs
one of the functions below on every rank; a rank returns plain Python and
numpy results that the test holds against JAX or against the port's
one-process model. The spawned child imports this module again, so it
imports no JAX: the tests do that in the parent.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240.0

# the inference checks' sizes (JAX's test_sharding.py), and the serving
# model's, which needs the full 1500-position audio context
SIZE = dict(n_state=128, n_head=4, n_layer=2, n_audio_ctx=64, n_text_ctx=64)
SERVE_SIZE = dict(n_state=128, n_head=4, n_layer=2)
# training's (test_torch_train.py), and the fine-tune tool's
TRAIN_SIZE = dict(n_state=128, n_head=2, n_layer=2, n_audio_ctx=32, n_text_ctx=32)
FT_SIZE = dict(n_state=128, n_head=2, n_layer=2)
FT_MODEL = "finetune-test"
TEST_MODEL = "parallel-test"  # SIZE's name in the children's CONFIGS
TRANSCRIBE_KW = dict(language="en", temperature=0.0, sample_len=8,
                     no_speech_threshold=None, logprob_threshold=None,
                     compression_ratio_threshold=None)


def spawn(world: int, fn, *args, timeout: float = JOIN_TIMEOUT_S,
          pg_timeout_s: float = 120.0) -> list:
    """Run fn(*args) on `world` gloo ranks whose process group times out
    a collective after `pg_timeout_s`; every rank's result, by rank. A
    rank that raises or does not finish within `timeout` fails the call;
    no child outlives it."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, store, fn, args, q, pg_timeout_s),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            while len(results) + len(errors) < world:
                try:
                    rank, ok, value = q.get(timeout=timeout)
                except queue.Empty:
                    errors.append(f"ranks timed out after {timeout} s")
                    break
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def _entry(rank, world, store, fn, args, q, pg_timeout_s):
    torch.set_num_threads(1)
    try:
        from openai_whisper_coreml_tpu_torch.parallel import initialize_distributed

        initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                               timeout_s=pg_timeout_s)
        try:
            q.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, False, traceback.format_exc()))


class OneRankReduces:
    """While entered, counts the all_reduce calls over a group of one rank:
    collectives that do no work, which a mesh axis of size 1 must not
    issue."""

    def __enter__(self):
        self.count, self._reduce = 0, dist.all_reduce

        def counted(tensor, *a, group=None, **k):
            if dist.get_world_size(group) == 1:
                self.count += 1
            return self._reduce(tensor, *a, group=group, **k)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._reduce


# -- inference ---------------------------------------------------------------

def _tree(npz_path):
    from openai_whisper_coreml_tpu_torch.params import tree_from_numpy
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import unflatten_params

    with np.load(npz_path) as f:
        return tree_from_numpy(unflatten_params({k: f[k] for k in f.files}))


def _local_leaves(model):
    """The rank's leaves (JAX layout) without the replicated tables."""
    from openai_whisper_coreml_tpu_torch.params import params_tree
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

    return {k: v.numpy() for k, v in flatten_params(params_tree(model)).items()
            if not k.endswith("_embedding")}


def _tokens(results):
    return [r.tokens for r in results]


def infer_checks(n_data: int, n_model: int, data_dir: str) -> dict:
    """Every inference check of one mesh, on this rank, counting the
    collectives over one rank that they issue."""
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data, n_model)
    with OneRankReduces() as counter:
        out = _infer_checks(mesh, data_dir)
    out["one_rank_reduces"] = counter.count
    return out


def _infer_checks(mesh, data_dir: str) -> dict:
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.decoding import (DecodingOptions,
                                                           decode,
                                                           detect_language)
    from openai_whisper_coreml_tpu_torch.models.layers import ParallelLinear
    from openai_whisper_coreml_tpu_torch.models.whisper import (load_model,
                                                                model_from_params)
    from openai_whisper_coreml_tpu_torch.parallel.mesh import (AXIS_MODEL, axis_size,
                                                                model_axis)
    from openai_whisper_coreml_tpu_torch.serve import ServeOptions, transcribe_batch

    n_model = axis_size(mesh, AXIS_MODEL)
    cfg = tiny_test_config(**SIZE)
    params = _tree(os.path.join(data_dir, "params.npz"))
    model = model_from_params(cfg, params, mesh=mesh)
    layout = {"parallel_linears": sum(isinstance(m, ParallelLinear)
                                      for m in model.modules()),
              "sharded_convs": sum(c.axis is not None for c in
                                   (model.encoder.conv1, model.encoder.conv2))}
    out = {"layout": layout, "leaves": _local_leaves(model),
           "leaves_int8": _local_leaves(model_from_params(
               cfg, params, quantize="int8", mesh=mesh))}
    with np.load(os.path.join(data_dir, "inputs.npz")) as f:
        mel, tokens, audios = f["mel"], f["tokens"], [f[f"a{i}"] for i in range(5)]
        lin = {k: torch.from_numpy(f[f"lin_{k}"]).bfloat16()
               for k in ("x", "w", "b", "lora_a", "lora_b")}
    axis = model_axis(mesh)
    if axis is not None:
        # a bf16 row-parallel linear with LoRA: this rank's input rows
        n = lin["w"].shape[0] // axis.size
        rows = slice(axis.rank * n, (axis.rank + 1) * n)
        row = ParallelLinear({"w": lin["w"][rows], "b": lin["b"], "lora_a": lin["lora_a"],
                              "lora_b": lin["lora_b"]}, axis, "row")
        out["row_bf16"] = row(lin["x"][..., rows]).float().numpy()
    with torch.no_grad():
        out["logits"] = model.logits(tokens, model.encode(mel)).numpy()

    opts = DecodingOptions(language="en", sample_len=12)
    out["greedy"] = _tokens(decode(model, mel, opts))
    out["beam"] = _tokens(decode(model, mel[:2], DecodingOptions(
        language="en", sample_len=8, beam_size=2)))
    out["odd"] = _tokens(decode(model, mel[:3], DecodingOptions(
        language="en", sample_len=6)))
    out["lang"] = detect_language(model, mel[:2])
    sampled = DecodingOptions(language="en", sample_len=12, temperature=0.9)
    out["sampled"] = _tokens(decode(model, mel[:3], sampled, seed=5))
    out["best_of"] = _tokens(decode(model, mel[:3], DecodingOptions(
        language="en", sample_len=8, temperature=0.7, best_of=2), seed=2))
    out["spec"] = _tokens(decode(model, mel, DecodingOptions(
        language="en", sample_len=12, spec_k=3), draft=model))

    errors = {}
    plain = model_from_params(cfg, params)
    try:
        decode(model, mel, opts, draft=plain)
    except ValueError as e:
        errors["draft_off_mesh"] = str(e)
    if n_model > 1:
        try:
            model_from_params(tiny_test_config(**dict(SIZE, n_state=96, n_head=3)),
                              params, mesh=mesh)
        except ValueError as e:
            errors["heads"] = str(e)
    from openai_whisper_coreml_tpu_torch import config as tconfig

    tconfig.CONFIGS[TEST_MODEL] = cfg
    try:
        load_model(TEST_MODEL, checkpoint=os.path.join(data_dir, "int8.safetensors"),
                   device="cpu", mesh=mesh)
    except ValueError as e:
        errors["prequantized"] = str(e)
    out["errors"] = errors

    serve = model_from_params(tiny_test_config(**SERVE_SIZE),
                              _tree(os.path.join(data_dir, "serve_params.npz")),
                              mesh=mesh)
    res = transcribe_batch(serve, audios, ServeOptions(
        scheduler="continuous", batch_size=4, language="en", temperature=(0.0,),
        sample_len=8, no_speech_threshold=None, logprob_threshold=None,
        compression_ratio_threshold=None))
    out["cb"] = [[t for seg in r["segments"] for t in seg["tokens"]] for r in res]
    out["transcribe"] = [s["tokens"] for s in serve.transcribe(
        audios[1], **TRANSCRIBE_KW)["segments"]]

    return out


# -- training ----------------------------------------------------------------

def train_batches(cfg, n_batches: int = 4):
    """Batches of 4 rows whose halves hold unequal token counts: rows 0-1
    long texts, rows 2-3 short ones, so each data rank of a (2, m) mesh
    holds another count (a mean of per-rank means would differ from the
    global token mean)."""
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
    from openai_whisper_coreml_tpu_torch.train import make_batch

    tok = get_tokenizer(cfg)
    rng = np.random.default_rng(0)
    out = []
    for s in range(n_batches):
        mel = rng.standard_normal((4, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
        texts = [f"one two three four five six {s}", f"seven eight nine ten {s} a b",
                 f"x {s}", f"{s}"]
        out.append(make_batch(cfg, tok, mel, texts, max_len=16))
    return out


TRAIN_CASES = {
    # full fine-tune, accumulation over 2 micro-batches, clipping that acts,
    # the flash path (the plain reference on the CPU), cosine schedule
    "full": (dict(accum_steps=2, max_grad_norm=0.05, flash=True,
                  schedule="cosine", warmup_steps=1, total_steps=3,
                  learning_rate=1e-3), False, 4),
    # one LoRA step on an int8 base, adapters only. AdamW's eps = 1 keeps
    # the update proportional to the gradient: with eps = 1e-6, elements
    # whose gradient sits near eps turn float noise of another summation
    # order (1e-7) into 1e-4 of their update, whatever the sharding.
    "lora": (dict(trainable="lora_", learning_rate=1.0, eps=1.0), True, 1),
}


def train_tree(cfg, lora: bool):
    """The full starting tree (every process makes the same one)."""
    from openai_whisper_coreml_tpu_torch.lora import add_lora
    from openai_whisper_coreml_tpu_torch.params import init_params
    from openai_whisper_coreml_tpu_torch.quantize import quantize_params

    tree = init_params(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    if lora:
        # adapters on column- (q, v) and row-parallel (out, fc2) linears,
        # fc2's base int8
        tree = add_lora(quantize_params(tree), rank=4, seed=1,
                        targets=r"(attn|cross_attn)/(q|v|out)$|mlp/fc2$")
        # B starts at zero, which leaves A without a gradient on the first
        # step: start it small and random so both adapters train
        gen = torch.Generator().manual_seed(2)

        def seed_b(node):
            if not isinstance(node, dict):
                return node
            out = {k: seed_b(v) for k, v in node.items()}
            if "lora_b" in node:
                out["lora_b"] = 0.02 * torch.randn(node["lora_b"].shape, generator=gen)
            return out

        tree = seed_b(tree)
    return tree


def run_training(case: str, mesh=None):
    """(losses, full tree as flat numpy) after the case's micro-steps."""
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.parallel import gather_params
    from openai_whisper_coreml_tpu_torch.train import TrainConfig, make_train_step
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

    tc_kw, lora, steps = TRAIN_CASES[case]
    cfg = tiny_test_config(**TRAIN_SIZE)
    model = model_from_params(cfg, train_tree(cfg, lora), mesh=mesh)
    init_fn, step_fn = make_train_step(cfg, TrainConfig(**tc_kw), mesh=mesh)
    model, state = init_fn(model)
    losses = []
    for mel, tokens, mask in train_batches(cfg, steps):
        model, state, metrics = step_fn(model, state, mel, tokens, mask)
        losses.append(float(metrics["loss"]))
    tree = {k: v.detach().numpy() for k, v in
            flatten_params(gather_params(model)).items()}
    return losses, tree


def train_checks(n_data: int, n_model: int) -> dict:
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data, n_model)
    out = {}
    with OneRankReduces() as counter:
        for case in TRAIN_CASES:
            losses, tree = run_training(case, mesh)
            # rank 0 returns the gathered tree; the others a digest of theirs
            out[case] = (losses, tree if dist.get_rank() == 0 else
                         {k: float(np.abs(v).sum()) for k, v in tree.items()})
    out["one_rank_reduces"] = counter.count
    return out


def _register_ft_config():
    from openai_whisper_coreml_tpu_torch import config as tconfig
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config

    tconfig.CONFIGS[FT_MODEL] = tiny_test_config(**FT_SIZE)


def finetune_run(argv) -> tuple:
    """finetune.main(argv) on this rank: (the paths that this rank's
    save_params / save_train_state calls wrote, what it printed)."""
    import contextlib
    import io

    from openai_whisper_coreml_tpu_torch import finetune
    from openai_whisper_coreml_tpu_torch.utils import checkpoint

    _register_ft_config()
    writes = []
    save_params, save_state = checkpoint.save_params, checkpoint.save_train_state

    def record(fn, path_arg):
        def wrapped(*a, **k):
            writes.append(a[path_arg])
            return fn(*a, **k)
        return wrapped

    checkpoint.save_params = record(save_params, 1)
    checkpoint.save_train_state = record(save_state, 0)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert finetune.main(argv) == 0
    finally:
        checkpoint.save_params, checkpoint.save_train_state = save_params, save_state
    return writes, out.getvalue()


def cli_model(name, mesh=None, **kw):
    """The CLI tests' load_model: the serving-size tiny model on the CPU
    (the weights made from a torch seed), on the CLI's mesh."""
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.models.whisper import build_model

    return build_model(tiny_test_config(**SERVE_SIZE), device="cpu", mesh=mesh)


def cli_run(argv) -> list:
    """cli.main(argv) on this rank with `cli_model` for load_model; the
    files this rank's write_result calls wrote."""
    import openai_whisper_coreml_tpu_torch as pkg
    from openai_whisper_coreml_tpu_torch import cli
    from openai_whisper_coreml_tpu_torch.utils import writers

    writes = []
    write_result = writers.write_result

    def record(result, path, out_dir, fmt, **kw):
        writes.append((os.path.basename(path), fmt))
        return write_result(result, path, out_dir, fmt, **kw)

    load = pkg.load_model
    pkg.load_model, writers.write_result = cli_model, record
    try:
        assert cli.main(argv) == 0
    finally:
        pkg.load_model, writers.write_result = load, write_result
    return writes


# -- word timestamps, streams and the HTTP server under a mesh ------------------

# the alignment pass's checks: 4 heads (two a rank on a model axis of 2),
# JAX's 64-position alignment geometry
ALIGN_SIZE = dict(n_state=128, n_head=4, n_layer=2, n_audio_ctx=64, n_text_ctx=96)
# every selected head on model rank 0 of 2: rank 1 joins each sum with zeros
SPARSE_HEADS = [[0, 0], [1, 1]]
WORDS_KW = dict(language="en", temperature=0.0, sample_len=8, word_timestamps=True,
                no_speech_threshold=None, logprob_threshold=None,
                compression_ratio_threshold=None)
BATCH_WORDS_KW = dict(batch_size=2, language="en", temperature=(0.0,), sample_len=8,
                      chunk_tokens=4, word_timestamps=True, no_speech_threshold=None,
                      logprob_threshold=None, compression_ratio_threshold=None)
ALIGN_FRAMES = (128, 100, 14, 8)  # full, the tail fix, n_audio == width, below


def timings(ws) -> list:
    return [(w.word, list(w.tokens), w.start, w.end, w.probability) for w in ws]


def _heads_model(cfg, params, mesh, sparse: bool):
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.timing import load_alignment_heads

    heads = load_alignment_heads(SPARSE_HEADS, cfg) if sparse else None
    return model_from_params(cfg, params, mesh=mesh, alignment_heads=heads)


def words_checks(n_data: int, n_model: int, data_dir: str, full: bool) -> dict:
    """Word timestamps on this rank: `transcribe` (with a
    hallucination_silence_threshold too when `full`), `transcribe_batch`
    under both schedulers, and `find_word_alignment` at each branch of a
    window and `find_word_alignment_batch`, with the default heads and
    (on a model axis) the sparse mask."""
    from openai_whisper_coreml_tpu_torch import timing
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh
    from openai_whisper_coreml_tpu_torch.serve import ServeOptions, transcribe_batch
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    mesh = make_mesh(n_data, n_model)
    masks = (False, True) if n_model > 1 else (False,)
    cfg = tiny_test_config(**SERVE_SIZE)
    params = _tree(os.path.join(data_dir, "serve_params.npz"))
    acfg = tiny_test_config(**ALIGN_SIZE)
    aparams = _tree(os.path.join(data_dir, "align_params.npz"))
    with np.load(os.path.join(data_dir, "words_inputs.npz")) as f:
        clip, clips = f["clip"], [f["b0"], f["b1"]]
        feats = f["feats"]
    tok = get_tokenizer(acfg, language="en")
    text = tok.encode(" alpha beta gamma delta")
    out = {}
    for sparse in masks:
        tag = "sparse" if sparse else "default"
        model = _heads_model(cfg, params, mesh, sparse)
        thresholds = (None, 0.5) if full and not sparse else (None,)
        for thr in thresholds:
            out[("transcribe", tag, thr)] = model.transcribe(
                clip, hallucination_silence_threshold=thr, **WORDS_KW)
        for scheduler in ("static", "continuous"):
            out[("batch", tag, scheduler)] = transcribe_batch(
                model, clips, ServeOptions(scheduler=scheduler, **BATCH_WORDS_KW))
        amodel = _heads_model(acfg, aparams, mesh, sparse)
        for frames in ALIGN_FRAMES:
            out[("align", tag, frames)] = timings(timing.find_word_alignment(
                amodel, tok, text, feats[:1], num_frames=frames))
        jobs = [(text, feats[1], 128), (tok.encode(" one two three"), feats[2], 128),
                (tok.encode(" x y"), feats[3], 40)]
        out[("align_batch", tag)] = [timings(t) for t in timing.find_word_alignment_batch(
            amodel, tok, jobs, language="en")]
    return out


STREAM_CASES = {  # test_torch_stream.py's StreamingTranscriber cases
    "agreement-2": (8, dict(agreement=2, decode_interval=2.0, sample_len=6)),
    "trim": (32, dict(agreement=1, decode_interval=4.0, sample_len=4)),
}
MULTI_KW = dict(n_streams=2, language="en", agreement=2, decode_interval=1.0,
                sample_len=6)
MULTI_PROMPT = [44, 45]  # stream 1's committed text


def stream_events(evs) -> list:
    return [(e.text, list(e.tokens), e.is_final) for e in evs]


def run_stream(st, audio) -> list:
    """1 s chunks, then finish: every event."""
    sr = 16_000
    out = []
    for off in range(0, len(audio), sr):
        out += stream_events(st.feed(audio[off:off + sr]))
    return out + stream_events(st.finish())


def run_multistream(mst, audios) -> dict:
    """Two streams polled each second, then finished: their events."""
    sr = 16_000
    mst.streams[1]._prompt = list(MULTI_PROMPT)
    out = {0: [], 1: []}
    for off in range(0, max(len(a) for a in audios), sr):
        for i, a in enumerate(audios):
            if off < len(a):
                mst.feed(i, a[off:off + sr])
        for i, evs in mst.poll().items():
            out[i] += stream_events(evs)
    for i in out:
        out[i] += stream_events(mst.finish(i))
    return out


def stream_checks(n_data: int, n_model: int, data_dir: str) -> dict:
    """Both stream classes on this rank, plain and with the model as its
    own draft."""
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh
    from openai_whisper_coreml_tpu_torch.stream import (MultiStreamTranscriber,
                                                         StreamingTranscriber)

    mesh = make_mesh(n_data, n_model)
    model = model_from_params(tiny_test_config(**SERVE_SIZE),
                              _tree(os.path.join(data_dir, "serve_params.npz")),
                              mesh=mesh)
    with np.load(os.path.join(data_dir, "stream_inputs.npz")) as f:
        audio = {name: f[name] for name in STREAM_CASES}
        multi = [f["m0"], f["m1"]]
    out = {}
    for name, (_, kw) in STREAM_CASES.items():
        out[name] = run_stream(StreamingTranscriber(model, language="en", **kw),
                               audio[name])
    out["multi"] = run_multistream(MultiStreamTranscriber(model, **MULTI_KW), multi)
    name = "agreement-2"
    st = StreamingTranscriber(model, language="en", draft_model=model, spec_k=3,
                              **STREAM_CASES[name][1])
    out["draft"] = run_stream(st, audio[name])
    out["draft_pinned"] = st._spec_gov.pinned
    mst = MultiStreamTranscriber(model, draft_model=model, spec_k=3, **MULTI_KW)
    out["multi_draft"] = run_multistream(mst, multi)
    out["multi_draft_pinned"] = mst._spec_gov.pinned
    return out


# the HTTP server's: deterministic serving defaults for a random model
SERVER_DEFAULTS = dict(language="en", sample_len=4, temperature=(0.0,),
                       no_speech_threshold=None, logprob_threshold=None,
                       compression_ratio_threshold=None)
BAD_REQUESTS = (  # answered 400 before any model command
    ("/transcribe?beam_size=x", "wav"),
    ("/transcribe?word_timestamps=1&without_timestamps=1", "wav"),
    ("/transcribe?temperature=hot", "wav"),
    ("/stream?decode_interval=soon", "raw"),
    ("/transcribe", "garbage"),
)


def wav_bytes(audio) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16_000)
        wf.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _multipart(fields: dict, data: bytes):
    bound = "whisperportboundary42"
    body = b""
    for k, vals in fields.items():
        for v in (vals if isinstance(vals, list) else [vals]):
            body += (f"--{bound}\r\nContent-Disposition: form-data; "
                     f"name=\"{k}\"\r\n\r\n{v}\r\n").encode()
    body += (f"--{bound}\r\nContent-Disposition: form-data; name=\"file\"; "
             "filename=\"a.wav\"\r\nContent-Type: application/octet-stream\r\n\r\n"
             ).encode() + data + b"\r\n" + f"--{bound}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={bound}"}


def http_exercise(port: int, clips, idle_s: float = 0.0, ops=None) -> dict:
    """Every route of a server on 127.0.0.1:port, as a client sends them:
    (status, body) per request, bodies parsed (JSON, NDJSON lines or
    text). `ops`: the server's list of model commands, to count what the
    bad requests sent; `idle_s`: an idle period before the last request."""
    import json
    import threading
    import time
    import urllib.error
    import urllib.request

    def call(path, body=None, headers=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                     headers=headers or {},
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                status, ctype, raw = r.status, r.headers.get("Content-Type", ""), r.read()
        except urllib.error.HTTPError as e:
            status, ctype, raw = e.code, e.headers.get("Content-Type", ""), e.read()
        text = raw.decode()
        if "ndjson" in ctype:
            return status, [json.loads(line) for line in text.splitlines()]
        return status, json.loads(text) if "json" in ctype else text

    def sent():
        return 0 if ops is None else sum(op != "noop" for op in ops)

    wavs = [wav_bytes(c) for c in clips]
    out = {"healthz": call("/healthz"), "readyz": call("/readyz"),
           "transcribe": call("/transcribe", wavs[0]),
           "transcribe_words": call("/transcribe?word_timestamps=1", wavs[1])}
    body, headers = _multipart({"model": "whisper-1", "response_format": "verbose_json",
                                "timestamp_granularities[]": "word"}, wavs[0])
    out["openai_verbose"] = call("/v1/audio/transcriptions", body, headers)
    body, headers = _multipart({"model": "whisper-1", "response_format": "srt"}, wavs[1])
    out["openai_srt"] = call("/v1/audio/transcriptions", body, headers)
    out["detect"] = call("/detect", wavs[1])
    raw = np.asarray(clips[1], np.float32).tobytes()
    out["stream"] = call("/stream?decode_interval=1.0", raw, {"X-Raw-Audio": "1"})

    pair = {}

    def post(i):
        pair[i] = call("/transcribe", wavs[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["concurrent"] = [pair[0], pair[1]]

    before = sent()
    payloads = {"wav": wavs[0], "raw": raw, "garbage": b"this is not audio"}
    out["bad"] = [call(path, payloads[kind]) for path, kind in BAD_REQUESTS]
    out["bad_sent"] = sent() - before
    out["model_error"] = call("/transcribe?language=xx", wavs[0])
    out["after_error"] = call("/transcribe", wavs[1])
    time.sleep(idle_s)
    out["after_idle"] = call("/transcribe", wavs[0])
    out["metrics"] = call("/metrics")
    return out


def server_checks(n_data: int, n_model: int, data_dir: str, idle_s: float) -> dict:
    """The mesh server: rank 0 serves on a free port and runs
    `http_exercise` against itself, then stops; the other ranks follow.
    Each rank returns the model commands it ran, in order."""
    from openai_whisper_coreml_tpu_torch import serve_http
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data, n_model)
    model = model_from_params(tiny_test_config(**SERVE_SIZE),
                              _tree(os.path.join(data_dir, "serve_params.npz")),
                              mesh=mesh)
    with np.load(os.path.join(data_dir, "server_inputs.npz")) as f:
        clips = [f["c0"], f["c1"]]
    ops = []
    execute = serve_http._execute

    def recording(model_, streams, cmd):
        ops.append(cmd[0])
        return execute(model_, streams, cmd)

    serve_http._execute = recording
    if dist.get_rank() != 0:
        serve_http.follow(model)
        return {"ops": ops}
    srv = serve_http.WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20,
                                       default_options=SERVER_DEFAULTS)
    srv.start()
    try:
        out = http_exercise(srv.port, clips, idle_s, ops)
    finally:
        srv.stop()
    out["ops"] = ops
    out["heartbeat_s"] = srv.heartbeat_s
    return out


def server_main_run(argv) -> dict:
    """serve_http.main(argv) on this rank with `cli_model` for load_model.
    Rank 0 sends one /transcribe once its server is up, then interrupts
    itself as Ctrl-C would; main must return 0 on every rank."""
    import json
    import signal
    import threading
    import urllib.request

    import openai_whisper_coreml_tpu_torch as pkg
    from openai_whisper_coreml_tpu_torch import serve_http

    out = {}
    started = threading.Event()
    start = serve_http.WhisperHTTPServer.start

    def recording_start(self):
        start(self)
        out["port"] = self.port
        started.set()

    def client():
        assert started.wait(120)
        q = ("language=en&temperature=0&no_speech_threshold=none"
             "&logprob_threshold=none&compression_ratio_threshold=none")
        req = urllib.request.Request(
            f"http://127.0.0.1:{out['port']}/transcribe?{q}",
            data=wav_bytes(0.1 * np.sin(np.arange(16_000) / 8.0)), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out["answer"] = (r.status, json.loads(r.read()))
        os.kill(os.getpid(), signal.SIGINT)

    load = pkg.load_model
    pkg.load_model, serve_http.WhisperHTTPServer.start = cli_model, recording_start
    try:
        if dist.get_rank() == 0:
            threading.Thread(target=client, daemon=True).start()
        out["rc"] = serve_http.main(argv)
    finally:
        pkg.load_model, serve_http.WhisperHTTPServer.start = load, start
    out["joined"] = dist.is_initialized()
    return out


def cli_capture(argv) -> tuple:
    """cli.main(argv) on this rank with `cli_model` for load_model: (what
    it printed to stdout, to stderr)."""
    import contextlib
    import io

    import openai_whisper_coreml_tpu_torch as pkg
    from openai_whisper_coreml_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    load = pkg.load_model
    pkg.load_model = cli_model
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert cli.main(argv) == 0
    finally:
        pkg.load_model = load
    return out.getvalue(), err.getvalue()
