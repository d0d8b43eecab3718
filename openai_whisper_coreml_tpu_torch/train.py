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

Updates are applied in place to the model's parameters.

Under a (data, model) mesh (`make_train_step(..., mesh=)`, one process per
rank, the model built on the same mesh) every rank is given the global
batch and trains on its data rank's rows; the loss is one token mean over
the global batch (the masked-token count is summed over the data group,
as JAX's `train.py` divides by the global count), parameter gradients are
summed over the data group, and the clip norm sums the squares of sharded
leaves over the model group and counts replicated leaves once. AdamW and
the accumulation window act on each rank's shards. `parallel.gather_params`
gives the full tree (for `save_params`).
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

    def __init__(self, tc: TrainConfig, labels: Mapping[str, bool],
                 sharded: Optional[set] = None, model_group=None):
        """sharded / model_group: under a mesh, the names of the leaves cut
        over the model group and that group, for the clip norm."""
        if tc.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
        self.tc = tc
        self.names = [n for n, train in labels.items() if train]
        self.lr = learning_rate_schedule(tc)
        self.sharded, self.model_group = sharded, model_group

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

    def _global_norm(self, grads) -> torch.Tensor:
        if self.model_group is None:
            return torch.sqrt(sum((grads[n].float() ** 2).sum() for n in self.names))
        sq = {s: sum(((grads[n].float() ** 2).sum() for n in self.names
                      if (n in self.sharded) == s),
                     torch.zeros((), device=grads[self.names[0]].device))
              for s in (True, False)}
        torch.distributed.all_reduce(sq[True], group=self.model_group)
        return torch.sqrt(sq[True] + sq[False])

    def _adamw(self, grads, state, params) -> None:
        tc = self.tc
        norm = self._global_norm(grads)
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
    labels = trainable_labels(model, tc.trainable)
    axis = model.decoder.axis
    if axis is None:
        return Optimizer(tc, labels)
    from .parallel.sharding import module_shard_dims

    sharded = {n for n, d in module_shard_dims(model).items() if d is not None}
    return Optimizer(tc, labels, sharded=sharded, model_group=axis.group)


def _data_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A detached copy of x summed over the data group."""
    x = x.detach().clone()
    torch.distributed.all_reduce(x, group=group)
    return x


def loss_fn(model, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, *, remat: bool = True,
            flash: bool = False, data_group=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forcing CE: predict tokens[:, 1:] from tokens[:, :-1].
    mel (B, n_mels, frames), tokens (B, T) [sot_sequence, text..., eot]
    padded, loss_mask (B, T) 1 where the token is a target.

    data_group: this rank holds a data rank's rows; the loss is then this
    rank's term of the global token mean (its summed NLL over the global
    token count), and the metrics are the global batch's."""
    feats = model.encoder(mel, remat=remat, flash=flash)
    logits = dec_mod.decoder_forward(model.decoder, tokens[:, :-1],
                                     audio_features=feats, remat=remat,
                                     flash=flash)
    targets = tokens[:, 1:]
    mask = loss_mask[:, 1:].float()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, targets[..., None])[..., 0]
    count = mask.sum()
    if data_group is not None:
        count = _data_sum(count, data_group)
    denom = torch.clamp(count, min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(dim=-1) == targets) * mask).sum() / denom
    if data_group is None:
        return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": count}
    return loss, {"loss": _data_sum(loss, data_group),
                  "accuracy": _data_sum(acc, data_group), "tokens": count}


def _batch(model, mel, tokens, loss_mask, mesh=None):
    """The batch on the model's device; under a mesh, this data rank's rows
    (the global batch must divide the data axis)."""
    dev = model.device
    out = (torch.as_tensor(mel, device=dev).float(),
           torch.as_tensor(tokens, device=dev).long(),
           torch.as_tensor(loss_mask, device=dev).float())
    if mesh is None:
        return out
    from .parallel.distributed import local_batch_slice

    rows = local_batch_slice(out[0].shape[0], mesh)
    return tuple(t[rows] for t in out)


def _check_mesh(model, mesh) -> None:
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model must be built on the train step's mesh "
                         "(load_model(..., mesh=mesh))")


def _data_group(mesh):
    """The data group, or None without a mesh or on a data axis of one
    rank (whose sums would be collectives that do no work)."""
    from .parallel.mesh import AXIS_DATA, axis_group, axis_size

    if axis_size(mesh, AXIS_DATA) == 1:
        return None
    return axis_group(mesh, AXIS_DATA)


def partial_grad_names(model) -> set:
    """Replicated leaves that a rank uses only in part (LoRA adapters of
    the parallel linears, `ParallelLinear.partial_grads`): their
    gradients are summed over the model group."""
    from .models.layers import ParallelLinear

    return {f"{name}.{leaf}" for name, mod in model.named_modules()
            if isinstance(mod, ParallelLinear)
            for leaf in mod.partial_grads if getattr(mod, leaf) is not None}


def make_train_step(cfg: WhisperConfig, tc: TrainConfig = TrainConfig(),
                    mesh=None):
    """(init_fn, step_fn) on the model's device.

    init_fn(model) -> (model, opt_state) marks the trainable parameters
    (`requires_grad`) and makes the optimizer state. step_fn(model,
    opt_state, mel, tokens, loss_mask) -> (model, opt_state, metrics)
    updates both in place.

    mesh: the (data, model) DeviceMesh the model was built on (see the
    module docstring); every rank passes the same global batch.
    """
    cell: Dict[str, Any] = {}
    data_group = _data_group(mesh)

    def init_fn(model):
        _check_mesh(model, mesh)
        opt = cell["opt"] = make_optimizer(tc, model)
        cell["partial"] = partial_grad_names(model)
        for name, p in model.named_parameters():
            p.requires_grad_(name in opt.names)
        return model, opt.init(dict(model.named_parameters()))

    def step_fn(model, opt_state, mel, tokens, loss_mask):
        opt = cell["opt"]
        named = dict(model.named_parameters())
        loss, metrics = loss_fn(model, *_batch(model, mel, tokens, loss_mask, mesh),
                                remat=tc.remat, flash=tc.flash,
                                data_group=data_group)
        grads = torch.autograd.grad(loss, [named[n] for n in opt.names])
        if data_group is not None or cell["partial"]:
            grads = _reduce_grads(model, dict(zip(opt.names, grads)),
                                  cell["partial"], data_group)
            grads = [grads[n] for n in opt.names]
        opt.update(dict(zip(opt.names, grads)), opt_state, named)
        return model, opt_state, metrics

    return init_fn, step_fn


def _reduce_grads(model, grads: Dict[str, torch.Tensor], partial: set,
                  data_group) -> Dict[str, torch.Tensor]:
    """Sum every gradient over the data group (each rank's loss is one
    term of the global mean), where the data axis has more than one rank,
    and the partly used replicated leaves' over the model group."""
    from torch.distributed import all_reduce

    out = {}
    for name, g in grads.items():
        if data_group is not None or name in partial:
            g = g.clone()
        if data_group is not None:
            all_reduce(g, group=data_group)
        if name in partial:
            all_reduce(g, group=model.decoder.axis.group)
        out[name] = g
    return out


def make_eval_step(cfg: WhisperConfig, tc: TrainConfig = TrainConfig(),
                   mesh=None):
    """eval_fn(model, mel, tokens, loss_mask) -> {"loss", "accuracy",
    "tokens"}: forward only, no remat, no gradients; under a mesh, of the
    global batch."""
    data_group = _data_group(mesh)

    @torch.no_grad()
    def eval_fn(model, mel, tokens, loss_mask):
        _check_mesh(model, mesh)
        _, metrics = loss_fn(model, *_batch(model, mel, tokens, loss_mask, mesh),
                             remat=False, flash=tc.flash, data_group=data_group)
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
