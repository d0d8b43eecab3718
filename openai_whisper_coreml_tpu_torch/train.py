"""Training / fine-tuning on one device (port of `train.py`).

Teacher-forcing cross entropy on (mel, tokens) pairs and the JAX package's
optimizer, written to optax's arithmetic rather than to
`torch.optim.AdamW`:

  * `clip_by_global_norm`: g * max / norm (as `(g / norm) * max`) only when
    norm >= max, with no epsilon (`clip_grad_norm_` adds 1e-6 and always
    scales);
  * AdamW: moments mu, nu in the parameter's dtype (bf16 stays bf16),
    bias correction by 1 - b^t, u = mu_hat / (sqrt(nu_hat) + eps), decoupled
    weight decay u += wd * p, then u *= -lr;
  * learning-rate schedules count optimizer updates from 0, so the first
    update of a warmup runs at lr 0;
  * gradient accumulation (`optax.MultiSteps`): the running mean
    acc += (g - acc) / (n + 1) over the window, one optimizer update (and
    one schedule step) per window;
  * selective fine-tuning: the `trainable` regex is matched against JAX
    paths (`params.jax_path`, no layer index). Frozen leaves get no
    gradient, no moments, no weight decay and no part in the clip norm.
    int8 leaves are never trained.

Updates are applied in place to the model's parameters. The DP x TP mesh
of the JAX package is not ported (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .config import WhisperConfig
from .models import decoder as dec_mod
from .params import jax_path

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    remat: bool = True
    # flash attention (the Hopper kernel on the card): the encoder, and the
    # decoder's causal teacher forcing; the backward recomputes the plain
    # attention (ops/flash_attention.py)
    flash: bool = False
    # selective fine-tuning: regex over "/"-joined JAX param paths (e.g.
    # "^decoder", "ln|bias", "lora_"); None = every float leaf trains
    trainable: Optional[str] = None
    # "constant", "linear" or "cosine", each after a linear 0 -> lr warmup
    # of warmup_steps; decaying schedules need total_steps (in optimizer
    # updates: micro-steps / accum_steps)
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    # micro-batches per optimizer update (gradients are meaned)
    accum_steps: int = 1


def trainable_labels(model: torch.nn.Module,
                     pattern: Optional[str]) -> Dict[str, bool]:
    """Module parameter name -> trains. The pattern is searched in each
    parameter's JAX path; non-float (int8) leaves never train."""
    rx = re.compile(pattern) if pattern is not None else None
    labels = {name: p.is_floating_point()
              and (rx is None or rx.search(jax_path(name)) is not None)
              for name, p in model.named_parameters()}
    if not any(labels.values()):
        raise ValueError(f"trainable pattern {pattern!r} matches no parameters")
    return labels


# -- schedules: optax's formulas, in float32 as jnp computes them ------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count):
        count = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - count / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], np.float32]:
    def schedule(count):
        count = np.minimum(np.float32(count), np.float32(decay_steps))
        decay = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * count / np.float32(decay_steps)))
        return np.float32(init) * decay

    return schedule


def _join(schedules, boundaries) -> Callable[[int], np.float32]:
    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def learning_rate_schedule(tc: TrainConfig) -> Schedule:
    """TrainConfig's schedule: a float for the bare constant case, else
    optimizer-update count -> learning rate."""
    if tc.schedule not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {tc.schedule!r} "
                         "(constant | linear | cosine)")
    if tc.schedule == "constant":
        if tc.warmup_steps <= 0:
            return tc.learning_rate
        return _join([_linear(0.0, tc.learning_rate, tc.warmup_steps),
                      lambda count: np.float32(tc.learning_rate)],
                     [tc.warmup_steps])
    if tc.total_steps is None or tc.total_steps <= tc.warmup_steps:
        raise ValueError(
            f"{tc.schedule} schedule needs total_steps > warmup_steps "
            f"(got total_steps={tc.total_steps}, "
            f"warmup_steps={tc.warmup_steps})")
    decay_steps = tc.total_steps - tc.warmup_steps
    if tc.schedule == "cosine":
        decay = _cosine(tc.learning_rate, decay_steps)
    else:
        decay = _linear(tc.learning_rate, 0.0, decay_steps)
    return _join([_linear(0.0, tc.learning_rate, max(tc.warmup_steps, 1)),
                  decay], [tc.warmup_steps])


class Optimizer:
    """[freeze] -> clip_by_global_norm -> AdamW [-> gradient accumulation],
    applied in place to named parameters (see the module docstring).

    State (`init`): {"count": optimizer updates so far, "mu", "nu": name ->
    moment}, plus {"mini_step", "gradient_step", "acc": name -> running
    mean} with accumulation. Only trainable names have entries.
    """

    def __init__(self, tc: TrainConfig, labels: Mapping[str, bool]):
        if tc.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
        self.tc = tc
        self.names = [n for n, train in labels.items() if train]
        self.lr = learning_rate_schedule(tc)

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        def zeros():
            return {n: torch.zeros_like(params[n]) for n in self.names}

        state: Dict[str, Any] = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.tc.accum_steps > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor]) -> bool:
        """Take one micro-batch's gradients of the trainable parameters;
        returns True when an optimizer update was applied."""
        k = self.tc.accum_steps
        if k > 1:
            n = state["mini_step"]
            for name in self.names:
                acc = state["acc"][name]
                acc.add_((grads[name].to(acc.dtype) - acc) / (n + 1))
            state["mini_step"] = (n + 1) % k
            if n != k - 1:
                return False
            state["gradient_step"] += 1
            grads = state["acc"]
        self._adamw(grads, state, params)
        if k > 1:
            for acc in state["acc"].values():
                acc.zero_()
        return True

    def _adamw(self, grads, state, params) -> None:
        tc = self.tc
        norm = torch.sqrt(sum((grads[n].float() ** 2).sum() for n in self.names))
        clip = not bool(norm < tc.max_grad_norm)
        count = state["count"] + 1
        bc1 = np.float32(1) - np.float32(tc.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(tc.b2) ** np.float32(count)
        step = -self.learning_rate(state["count"])
        for name in self.names:
            p, mu, nu = params[name], state["mu"][name], state["nu"][name]
            g = grads[name]
            if clip:
                g = (g / norm.to(g.dtype)) * tc.max_grad_norm
            mu.copy_((1 - tc.b1) * g + tc.b1 * mu)
            nu.copy_((1 - tc.b2) * g ** 2 + tc.b2 * nu)
            u = (mu / torch.tensor(bc1, dtype=mu.dtype)) / (
                torch.sqrt(nu / torch.tensor(bc2, dtype=nu.dtype)) + tc.eps)
            u = u + tc.weight_decay * p
            p.copy_(p + torch.tensor(step, dtype=u.dtype) * u)
        state["count"] = count


def make_optimizer(tc: TrainConfig, model: torch.nn.Module) -> Optimizer:
    return Optimizer(tc, trainable_labels(model, tc.trainable))


def loss_fn(model, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, *, remat: bool = True,
            flash: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forcing CE: predict tokens[:, 1:] from tokens[:, :-1].
    mel (B, n_mels, frames), tokens (B, T) [sot_sequence, text..., eot]
    padded, loss_mask (B, T) 1 where the token is a target."""
    feats = model.encoder(mel, remat=remat, flash=flash)
    logits = dec_mod.decoder_forward(model.decoder, tokens[:, :-1],
                                     audio_features=feats, remat=remat,
                                     flash=flash)
    targets = tokens[:, 1:]
    mask = loss_mask[:, 1:].float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, targets[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(dim=-1) == targets) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": mask.sum()}


def _batch(model, mel, tokens, loss_mask):
    dev = model.device
    return (torch.as_tensor(mel, device=dev).float(),
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(loss_mask, device=dev).float())


def make_train_step(cfg: WhisperConfig, tc: TrainConfig = TrainConfig()):
    """(init_fn, step_fn) on the model's device.

    init_fn(model) -> (model, opt_state) marks the trainable parameters
    (`requires_grad`) and makes the optimizer state. step_fn(model,
    opt_state, mel, tokens, loss_mask) -> (model, opt_state, metrics)
    updates both in place.
    """
    cell: Dict[str, Optimizer] = {}

    def init_fn(model):
        opt = cell["opt"] = make_optimizer(tc, model)
        for name, p in model.named_parameters():
            p.requires_grad_(name in opt.names)
        return model, opt.init(dict(model.named_parameters()))

    def step_fn(model, opt_state, mel, tokens, loss_mask):
        opt = cell["opt"]
        named = dict(model.named_parameters())
        loss, metrics = loss_fn(model, *_batch(model, mel, tokens, loss_mask),
                                remat=tc.remat, flash=tc.flash)
        grads = torch.autograd.grad(loss, [named[n] for n in opt.names])
        opt.update(dict(zip(opt.names, grads)), opt_state, named)
        return model, opt_state, metrics

    return init_fn, step_fn


def make_eval_step(cfg: WhisperConfig, tc: TrainConfig = TrainConfig()):
    """eval_fn(model, mel, tokens, loss_mask) -> {"loss", "accuracy",
    "tokens"}: forward only, no remat, no gradients."""

    @torch.no_grad()
    def eval_fn(model, mel, tokens, loss_mask):
        _, metrics = loss_fn(model, *_batch(model, mel, tokens, loss_mask),
                             remat=False, flash=tc.flash)
        return metrics

    return eval_fn


def make_batch(cfg: WhisperConfig, tokenizer, mel, texts, language="en",
               max_len: Optional[int] = None):
    """Host-side batch assembly: [sot_seq] + text + [eot], right-padded
    (numpy int32 tokens, float32 loss_mask over the text+eot region)."""
    sot_seq = list(tokenizer.sot_sequence_including_notimestamps)
    rows, masks = [], []
    for text in texts:
        ids = sot_seq + tokenizer.encode(" " + text.strip()) + [tokenizer.eot]
        mask = [0] * len(sot_seq) + [1] * (len(ids) - len(sot_seq))
        rows.append(ids)
        masks.append(mask)
    L = max_len or max(len(r) for r in rows)
    tokens = np.full((len(rows), L), tokenizer.eot, np.int32)
    loss_mask = np.zeros((len(rows), L), np.float32)
    for i, (r, m) in enumerate(zip(rows, masks)):
        r, m = r[:L], m[:L]
        tokens[i, : len(r)] = r
        loss_mask[i, : len(m)] = m
    return mel, tokens, loss_mask
