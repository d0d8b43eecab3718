"""Fine-tune Whisper on a local (audio, transcript) corpus (port of
`tools/finetune.py`).

Corpus layouts: those `eval.harness.discover` finds (flat <name>.wav +
<name>.txt pairs, or LibriSpeech trees). Training runs `train.make_train_step`
on one device, the card unless `--device cpu` is given, and writes
safetensors checkpoints (and, with `--save-state`, the full train state for
an exact `--resume`). The flags are the JAX tool's. `--flash` puts the
Hopper flash kernel on the training path: the encoder's attention and the
decoder's causal teacher forcing. On the card each utterance's log-mel
runs the log-mel kernel once.

Under torchrun the run is data- and tensor-parallel (`parallel/`): a
(world / N, N) mesh for `--mesh-model N`, each rank training on its data
rank's rows of every batch (which the data axis must divide). Rank 0 alone
prints and writes checkpoints and train states (gathered from every
rank's shards); `--resume` reads the full state on every rank.

Usage:
  python -m openai_whisper_coreml_tpu_torch.finetune /data/corpus \\
      --model tiny --steps 100 --batch-size 8 --save-every 50 --output ckpts/ft
  torchrun --nproc-per-node 4 -m openai_whisper_coreml_tpu_torch.finetune \\
      /data/corpus --model large-v3 --mesh-model 2 --batch-size 8
"""

from __future__ import annotations

import argparse
import builtins
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import audio as audio_mod


def _mel(u, cfg, device) -> torch.Tensor:
    """One utterance's (n_mels, 3000) log-mel on `device`."""
    from .config import N_SAMPLES

    audio = audio_mod.pad_or_trim(audio_mod.load_audio(u.audio_path), N_SAMPLES)
    return audio_mod.log_mel_spectrogram(torch.as_tensor(audio, device=device),
                                         n_mels=cfg.n_mels)


def data_iterator(utts, batch_size, cfg, tokenizer, seed=0, max_len=None,
                  skip=0, device="cpu"):
    """Infinite shuffled batches of (mel on `device`, tokens, loss_mask).

    Each utterance's log-mel is computed once and kept on the device. skip:
    replay (and discard) this many batch draws first, so a resumed run sees
    exactly the batches an uninterrupted run would have; the RNG advances
    without touching any audio.
    """
    from .train import make_batch

    rng = np.random.default_rng(seed)
    cache = {}
    for _ in range(skip):
        rng.choice(len(utts), size=batch_size, replace=len(utts) < batch_size)
    while True:
        idx = rng.choice(len(utts), size=batch_size, replace=len(utts) < batch_size)
        mels, texts = [], []
        for i in idx:
            u = utts[int(i)]
            if u.utt_id not in cache:
                cache[u.utt_id] = _mel(u, cfg, device)
            mels.append(cache[u.utt_id])
            texts.append(u.reference)
        yield make_batch(cfg, tokenizer, torch.stack(mels), texts,
                         max_len=max_len)


def eval_batches(utts, batch_size, cfg, tokenizer, max_len=None, device="cpu"):
    """Fixed, deterministic batches over the whole held-out set.

    The last chunk is padded to batch_size by cycling earlier utterances
    with their loss masks zeroed, so padding contributes no tokens to the
    weighted metrics."""
    from .train import make_batch

    batches = []
    for start in range(0, len(utts), batch_size):
        chunk = utts[start:start + batch_size]
        n_real = len(chunk)
        while len(chunk) < batch_size:  # cycle-pad the final chunk
            chunk = chunk + utts[: batch_size - len(chunk)]
        mel = torch.stack([_mel(u, cfg, device) for u in chunk])
        mel, tokens, mask = make_batch(cfg, tokenizer, mel,
                                       [u.reference for u in chunk],
                                       max_len=max_len)
        mask[n_real:] = 0.0
        batches.append((mel, tokens, mask))
    return batches


def run_eval(eval_fn, model, batches):
    """Token-weighted loss/accuracy over fixed batches."""
    tot_loss = tot_acc = tot_tok = 0.0
    for mel, tokens, mask in batches:
        m = eval_fn(model, mel, tokens, mask)
        n = float(m["tokens"])
        tot_loss += float(m["loss"]) * n
        tot_acc += float(m["accuracy"]) * n
        tot_tok += n
    denom = max(tot_tok, 1.0)
    return tot_loss / denom, tot_acc / denom


def _map_opt_state(fn, model, opt_state):
    """fn(model, {name: tensor}) applied to the optimizer state's per-name
    tensors (moments, accumulation window)."""
    return {k: (fn(model, v) if isinstance(v, dict) else v)
            for k, v in opt_state.items()}


def restore(path: str, model, device) -> tuple:
    """Load a `--save-state` directory into the model in place: returns
    (opt_state on `device`, the saved step). Under a mesh every rank reads
    the full state and keeps its shards."""
    from .params import assign_params
    from .parallel.sharding import shard_named, shard_params
    from .utils.checkpoint import restore_train_state

    state = restore_train_state(path, map_location=device)
    params, opt_state = state["params"], state["opt_state"]
    if model.mesh is not None:
        params = shard_params(params, model.cfg, model.mesh)
        opt_state = _map_opt_state(shard_named, model, opt_state)
    assign_params(model, params)
    return opt_state, int(state["step"])


def _device(name: Optional[str]) -> torch.device:
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: fine-tuning runs on an NVIDIA "
                               "GPU; pass --device cpu to train on the CPU")
        name = "cuda"
    return torch.device(name)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("corpus")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None,
                    help="starting .safetensors checkpoint")
    ap.add_argument("--output", default="ckpts/finetuned")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=1e-5)
    ap.add_argument("--schedule", choices=("constant", "linear", "cosine"),
                    default="constant",
                    help="LR schedule (decay horizon = --steps, in "
                         "optimizer updates)")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear 0 -> lr warmup before the schedule")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient accumulation: micro-batches per "
                         "optimizer update (effective batch = "
                         "batch-size * accum-steps)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="TP degree under torchrun: a (world/N, N) data x "
                         "model mesh")
    ap.add_argument("--max-len", type=int, default=None,
                    help="token sequence cap (default: longest in batch)")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--save-state", default=None, metavar="DIR",
                    help="also write the FULL train state (params + "
                         "optimizer moments + step) to this dir at every "
                         "--save-every interval and at the end, for exact "
                         "--resume (torch.save; not JAX's orbax format)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="restore a --save-state dir and continue: the LR "
                         "schedule position rides in the optimizer state, "
                         "the data stream fast-forwards to the saved step")
    ap.add_argument("--holdout", type=float, default=0.0,
                    help="fraction of utterances held out of training for "
                         "evaluation (deterministic split by --seed)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate token-weighted loss/accuracy on the "
                         "held-out set every N steps (and after the last "
                         "step); needs --holdout > 0")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="train LoRA adapters of this rank instead of the "
                         "full model (0 = full fine-tune); composes with "
                         "int8-quantized bases")
    ap.add_argument("--lora-alpha", type=float, default=16.0)
    ap.add_argument("--lora-targets", default=None,
                    help="regex over linear paths (default: attention q/v)")
    ap.add_argument("--no-merge-lora", action="store_true",
                    help="save the final checkpoint with adapters separate "
                         "instead of merged into the base weights")
    ap.add_argument("--trainable", default=None,
                    help="regex over JAX param paths to fine-tune "
                         "selectively (e.g. '^decoder', 'ln|bias'); frozen "
                         "leaves allocate no optimizer state")
    ap.add_argument("--flash", action="store_true",
                    help="the flash-attention kernel in the encoder and the "
                         "decoder's causal teacher forcing (backward by "
                         "recompute of the plain attention)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    import torch.distributed as dist

    from .parallel.distributed import launched_ranks

    args = build_parser().parse_args(argv)
    if args.mesh_model == 1 and launched_ranks() == 1:
        return _train(args)
    from .parallel.mesh import AXIS_DATA, axis_size, launch_mesh

    joined = dist.is_initialized()
    mesh = launch_mesh(args.mesh_model, "--mesh-model")
    try:
        n_data = axis_size(mesh, AXIS_DATA)
        if args.batch_size % n_data:
            raise SystemExit(f"--batch-size {args.batch_size} must divide "
                             f"over the {n_data} data ranks")
        return _train(args, mesh)
    finally:
        if not joined:
            dist.destroy_process_group()


def _train(args, mesh=None) -> int:
    device = _device(args.device)

    from .eval.harness import discover
    from .models.whisper import load_model, model_from_params
    from .parallel.distributed import is_main_process
    from .parallel.sharding import gather_named, gather_params
    from .tokenizer import get_tokenizer
    from .train import TrainConfig, make_eval_step, make_train_step
    from .utils.checkpoint import save_params, save_train_state

    main_rank = is_main_process()
    # the one-card run makes the calls it made before the mesh
    on_mesh = {} if mesh is None else {"mesh": mesh}
    # rank 0 alone logs
    print = builtins.print if main_rank else (lambda *a, **k: None)  # noqa: A001

    utts = discover(args.corpus)
    if not utts:
        raise SystemExit(f"no training utterances under {args.corpus}")

    eval_utts = []
    if not 0.0 <= args.holdout < 1.0:
        raise SystemExit(f"--holdout must be in [0, 1), got {args.holdout}")
    if args.eval_every and args.holdout == 0.0:
        raise SystemExit("--eval-every needs --holdout > 0")
    if args.holdout > 0.0:
        order = np.random.default_rng(args.seed).permutation(len(utts))
        n_eval = max(1, int(round(len(utts) * args.holdout)))
        if n_eval >= len(utts):
            raise SystemExit(
                f"--holdout {args.holdout} leaves no training utterances "
                f"({len(utts)} total)")
        eval_utts = [utts[int(i)] for i in order[:n_eval]]
        utts = [utts[int(i)] for i in order[n_eval:]]
    print(f"{len(utts)} train / {len(eval_utts)} held-out utterances; "
          f"device: {device}")

    model = load_model(args.model, checkpoint=args.checkpoint, device=device,
                       **on_mesh)
    cfg = model.cfg
    tokenizer = get_tokenizer(cfg, language="en" if cfg.multilingual else None)

    trainable = args.trainable
    if args.lora_rank > 0:
        from .lora import add_lora, count_lora_params

        lora_kw = {"rank": args.lora_rank, "alpha": args.lora_alpha}
        if args.lora_targets:
            lora_kw["targets"] = args.lora_targets
        model = model_from_params(cfg, add_lora(gather_params(model), **lora_kw),
                                  mesh=mesh)
        trainable = trainable or "lora_"
        print(f"LoRA rank {args.lora_rank}: "
              f"{count_lora_params(model)/1e6:.2f}M trainable adapter params")

    # --steps counts micro-batches; decaying schedules run over optimizer
    # updates, which gradient accumulation divides by accum_steps
    total_updates = max(1, args.steps // args.accum_steps)
    init_fn, step_fn = make_train_step(
        cfg, TrainConfig(
            learning_rate=args.learning_rate,
            schedule=args.schedule, warmup_steps=args.warmup_steps,
            total_steps=(total_updates
                         if args.schedule != "constant" else None),
            accum_steps=args.accum_steps,
            trainable=trainable, flash=args.flash), **on_mesh)
    model, opt_state = init_fn(model)

    start_step = 0
    if args.resume:
        opt_state, start_step = restore(args.resume, model, device)
        print(f"resumed {args.resume} at step {start_step}")
        if start_step >= args.steps:
            print(f"nothing to do: saved step {start_step} >= "
                  f"--steps {args.steps}")

    eval_fn = None
    if args.eval_every:
        eval_fn = make_eval_step(cfg, TrainConfig(flash=args.flash), **on_mesh)
        held_out = eval_batches(eval_utts, args.batch_size, cfg, tokenizer,
                                max_len=args.max_len, device=device)

    def _save_state(step):
        if not args.save_state:
            return
        if mesh is None:
            save_train_state(args.save_state, model, opt_state=opt_state, step=step)
        else:
            tree = gather_params(model)
            full_opt = _map_opt_state(gather_named, model, opt_state)
            if main_rank:
                save_train_state(args.save_state, tree, opt_state=full_opt,
                                 step=step)
        print(f"saved train state {args.save_state} (step {step})", flush=True)

    it = data_iterator(utts, args.batch_size, cfg, tokenizer, seed=args.seed,
                       max_len=args.max_len, skip=start_step, device=device)
    t0 = time.time()
    last_state_saved = start_step if args.resume else -1
    for step in range(start_step + 1, args.steps + 1):
        mel, tokens, mask = next(it)
        model, opt_state, metrics = step_fn(model, opt_state, mel, tokens, mask)
        if step % args.log_every == 0 or step == start_step + 1:
            loss = float(metrics["loss"])
            acc = float(metrics["accuracy"])
            rate = (step - start_step) / (time.time() - t0)
            print(f"step {step}: loss={loss:.4f} acc={acc:.3f} "
                  f"({rate:.2f} steps/s)", flush=True)
        if eval_fn and (step % args.eval_every == 0 or step == args.steps):
            eloss, eacc = run_eval(eval_fn, model, held_out)
            print(f"eval step {step}: loss={eloss:.4f} acc={eacc:.3f} "
                  f"({len(eval_utts)} utts)", flush=True)
        if args.save_every and step % args.save_every == 0:
            path = f"{args.output}-{step}.safetensors"
            saved = model if mesh is None else gather_params(model)
            if main_rank:
                save_params(saved, path, model_name=cfg.name)
            print(f"saved {path}", flush=True)
            _save_state(step)
            last_state_saved = step
    if args.steps > last_state_saved:
        _save_state(args.steps)

    final = gather_params(model)
    if args.lora_rank > 0 and not args.no_merge_lora:
        from .lora import merge_lora

        final = merge_lora(final)
        print("merged LoRA adapters into base weights")
    path = f"{args.output}-final.safetensors"
    if main_rank:
        save_params(final, path, model_name=cfg.name)
    print(f"saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
