"""A plain Uni-MoE-2.0-Omni audio path in float32: the Whisper encoder, the
connector, the Qwen2-style decoder with its mixture of experts, and the
log-probabilities at a clip's last positions, written from the published
description (HIT-TMG/Uni-MoE-2.0-Omni `config.json`; Qwen2; openai/whisper
`model.py`) in plain PyTorch, one clip at a time, with no cache, no
packing and no batching.

It imports nothing of the program under test and takes none of its
derived state: it is handed the same seeded parameter tree, the clips'
log-mel windows and their prompts (the text before the audio and after
it). The program's int8 rule is the configuration's, so it is applied
here too by this file's own copy: weight-only, a per-output-channel scale
(the absolute maximum over the contraction axis over 127, round half to
even; a stacked (E, in, out) expert weight takes one scale per expert and
column) on every linear weight of `min_quant_size` elements or more,
except the router, which stays float32. Every step is float32 with TF32
off. `weight_bits=4` gives the control: the same rule at 4 bits (levels
-7..7).

The decoder's layers are read from `params["layers"]` one at a time and
cast as they are read, so that only one layer's float32 weights are held.
`forward` can run the experts under given routes (the program's), and it
reports at every layer and token the reference's own pick and the pick's
margin: how far the probabilities lie from changing it (from the top-p
threshold and from the rank boundary), so that a route comparison can
leave out the picks that rounding could flip.

Sizes come as a dictionary under `config.UniMoEConfig`'s field names."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

MIN_QUANT_SIZE = 1 << 16


def exact_float32() -> None:
    """float32 products as float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- the int8 rule ---------------------------------------------------------------------

def quantize(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """x rounded to `bits`-bit levels with one scale per slice along `dim`
    (the absolute maximum over `dim` over 2**(bits-1) - 1), as float32."""
    x32 = x.float()
    qmax = float(2 ** (bits - 1) - 1)
    amax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(torch.div(amax, torch.full_like(amax, qmax)), min=1e-12)
    return torch.clamp(torch.round(torch.div(x32, scale)), -qmax, qmax) * scale


def cast(tree, bits: int, min_size: int, name: str = "") -> dict:
    """The tree with every float leaf as float32 and every linear weight the
    rule takes at its `bits`-bit levels (not the convolutions', not the
    router's)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = cast(val, bits, min_size, key)
        elif (key == "w" and name not in ("conv1", "conv2", "router") and val.ndim in (2, 3)
              and val.numel() >= min_size):
            out[key] = quantize(val, bits, dim=-2)
        else:
            out[key] = val.float()
    return out


# -- the Whisper encoder (openai numerics) -------------------------------------------

def _ln(x, p, i=None):
    s, b = (p["scale"], p["bias"]) if i is None else (p["scale"][i], p["bias"][i])
    return F.layer_norm(x, x.shape[-1:], s, b, eps=1e-5)


def _lin(x, p, i=None):
    w = p["w"] if i is None else p["w"][i]
    y = x @ w
    if "b" in p:
        y = y + (p["b"] if i is None else p["b"][i])
    return y


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inc = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64, device=device))
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None]
    return torch.cat([t.sin(), t.cos()], dim=1).float()


def encode(e: dict, mel: torch.Tensor, n_head: int, n_layer: int) -> torch.Tensor:
    """(n_mels, 3000) -> (1500, n_audio_state)."""
    x = F.gelu(F.conv1d(mel.float()[None], e["conv1"]["w"].permute(2, 1, 0), e["conv1"]["b"],
                        padding=1))
    x = F.gelu(F.conv1d(x, e["conv2"]["w"].permute(2, 1, 0), e["conv2"]["b"], stride=2,
                        padding=1))[0].T
    x = x + _sinusoids(x.shape[0], x.shape[1], x.device)
    blk = e["blocks"]
    t, n = x.shape
    for i in range(n_layer):
        a = blk["attn"]
        y = _ln(x, blk["attn_ln"], i)
        q, k, v = (_lin(y, a[name], i).view(t, n_head, -1).transpose(0, 1)
                   for name in ("q", "k", "v"))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
        x = x + _lin((w @ v).transpose(0, 1).reshape(t, n), a["out"], i)
        y = _ln(x, blk["mlp_ln"], i)
        x = x + _lin(F.gelu(_lin(y, blk["mlp"]["fc1"], i)), blk["mlp"]["fc2"], i)
    return _ln(x, e["ln_post"])


def pool(frames: torch.Tensor, n_out: int) -> torch.Tensor:
    """Adaptive average pooling of (L, C) frames to (n_out, C): bin i is
    the mean of frames floor(i L / n_out) .. ceil((i + 1) L / n_out) - 1."""
    n = frames.shape[0]
    rows = []
    for i in range(n_out):
        lo, hi = (i * n) // n_out, -(-((i + 1) * n) // n_out)
        rows.append(frames[lo:hi].mean(dim=0))
    return torch.stack(rows)


# -- the decoder -----------------------------------------------------------------------

def _rms(x, p, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * p["scale"]


def _rope(x, positions, theta):
    """x (T, H, D) rotated by halves at `positions`."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=x.device).float()
                           / d))
    f = positions.float()[:, None] * inv[None]
    cos, sin = torch.cat([f, f], -1).cos()[:, None], torch.cat([f, f], -1).sin()[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _ids(tokens, device) -> torch.Tensor:
    return torch.as_tensor(list(tokens), dtype=torch.long, device=device)


def _swiglu(x, gate_up, down):
    f = gate_up.shape[-1] // 2
    h = x @ gate_up
    return (F.silu(h[:, :f]) * h[:, f:]) @ down


def own_pick(probs: torch.Tensor, c: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-p pick of (T, n_routes) probabilities, as a bit mask of the
    routed experts kept (bit e for expert e; null experts add none); its
    margin: the least distance of a kept/dropped decision from the top-p
    threshold (the sums before each of the first top_k sorted entries) and
    of the last kept entry from the next (the rank boundary); and the
    number of null experts kept."""
    s, order = probs.sort(dim=-1, descending=True)
    k = c["top_k"]
    before = torch.cat([torch.zeros_like(s[:, :1]), s[:, :k - 1].cumsum(dim=-1)], dim=-1)
    keep = before < c["top_p"]
    mask = torch.zeros(s.shape[0], dtype=torch.long, device=s.device)
    nulls = torch.zeros_like(mask)
    for j in range(k):
        real = keep[:, j] & (order[:, j] < c["n_experts"])
        mask = mask | torch.where(real, 1 << order[:, j], torch.zeros_like(order[:, j]))
        nulls = nulls + (keep[:, j] & ~real).long()
    margin = (before[:, 1:] - c["top_p"]).abs().amin(dim=-1) if k > 1 else \
        torch.full_like(s[:, 0], math.inf)
    kept = keep.sum(dim=-1)
    last = s.gather(1, (kept - 1)[:, None])[:, 0]
    following = s.gather(1, kept.clamp(max=s.shape[1] - 1)[:, None])[:, 0]
    boundary = torch.where(kept < s.shape[1], last - following, torch.full_like(last, math.inf))
    return mask, torch.minimum(margin, boundary), nulls


def moe(y: torch.Tensor, lp: dict, c: dict, routes: Optional[torch.Tensor] = None) -> dict:
    """One layer's mixture over normed rows y (T, hidden) of a cast layer
    tree `lp`: "y", the shared experts plus each picked routed expert
    weighted by its probability, with the routed experts of `routes` (T,
    top_k) in place of the layer's own pick when given; "pick", "margin"
    and "nulls" as `own_pick` gives them."""
    probs = torch.softmax(y @ lp["router"]["w"], dim=-1)
    mine, margin, nulls = own_pick(probs, c)
    use = mine if routes is None else route_mask(routes.to(y.device))
    out = torch.zeros_like(y)
    sh, ex = lp["shared"], lp["experts"]
    for s in range(c["n_shared"]):
        out = out + _swiglu(y, sh["gate_up"]["w"][s], sh["down"]["w"][s])
    for e in range(c["n_experts"]):
        sel = (use >> e) & 1 == 1
        if sel.any():
            out[sel] = out[sel] + probs[sel, e:e + 1] * _swiglu(
                y[sel], ex["gate_up"]["w"][e], ex["down"]["w"][e])
    return {"y": out, "pick": mine, "margin": margin, "nulls": nulls}


def route_mask(routes: torch.Tensor) -> torch.Tensor:
    """Routes (T, top_k), expert ids with -1 for none, as bit masks."""
    r = routes.long()
    bits = torch.where(r >= 0, 1 << r.clamp(min=0), torch.zeros_like(r))
    out = torch.zeros(r.shape[0], dtype=torch.long, device=r.device)
    for j in range(r.shape[1]):
        out = out | bits[:, j]
    return out


class Reference:
    """The audio path of sizes `c` over `params` in float32, with the
    configuration's int8 rule (`weight_bits` 8) or the control's 4 bits."""

    def __init__(self, params: dict, c: dict, weight_bits: int = 8,
                 min_quant_size: int = MIN_QUANT_SIZE):
        self.p, self.c, self.bits, self.min_size = params, c, weight_bits, min_quant_size

    def _cast(self, tree) -> dict:
        return cast(tree, self.bits, self.min_size)

    def audio(self, mel: torch.Tensor) -> torch.Tensor:
        """(n_mels, 3000) -> (audio_tokens, hidden)."""
        c = self.c
        enc = cast(self.p["encoder"], self.bits, MIN_QUANT_SIZE)  # Whisper's own rule
        frames = encode(enc, mel, c["n_audio_head"], c["n_audio_layer"])
        return _lin(pool(frames, c["audio_tokens"]), self._cast(
            {"connector": self.p["connector"]})["connector"])

    def forward(self, mels: Sequence[torch.Tensor], prompts: Sequence[tuple],
                routes: Optional[Sequence[torch.Tensor]] = None, tail: int = 1) -> Dict[str, list]:
        """Each clip's log-probabilities (tail, n_vocab) at its last `tail`
        positions ("logprobs"), with the routed experts of `routes` (each
        clip's (n_layer, T, top_k), -1 for none) in place of its own pick
        when given; and at every layer its own pick ("pick", (n_layer, T)
        bit masks), the pick's margin ("margin", (n_layer, T)) and its null
        experts ("nulls", (n_layer, T) counts)."""
        c = self.c
        embed = self.p["embed"].float()
        xs, picks, margins, nulls = [], [], [], []
        for mel, (before, after) in zip(mels, prompts):
            xs.append(torch.cat([embed[_ids(before, embed.device)], self.audio(mel),
                                 embed[_ids(after, embed.device)]]))
            picks.append([])
            margins.append([])
            nulls.append([])
        hq, hk, d = c["n_head"], c["n_kv_head"], c["hidden"] // c["n_head"]
        for i in range(c["n_layer"]):
            lp = self._cast(self.p["layers"][i])
            a = lp["attn"]
            for b, x in enumerate(xs):
                t = x.shape[0]
                pos = torch.arange(t, device=x.device)
                y = _rms(x, lp["attn_norm"], c["rms_eps"])
                q = _rope(_lin(y, a["q"]).view(t, hq, d), pos, c["rope_theta"])
                k = _rope(_lin(y, a["k"]).view(t, hk, d), pos, c["rope_theta"])
                v = _lin(y, a["v"]).view(t, hk, d)
                k, v = k.repeat_interleave(hq // hk, dim=1), v.repeat_interleave(hq // hk, dim=1)
                w = (q.transpose(0, 1) @ k.permute(1, 2, 0)) / math.sqrt(d)
                causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
                w = torch.softmax(w.masked_fill(~causal, float("-inf")), dim=-1)
                x = x + _lin((w @ v.transpose(0, 1)).transpose(0, 1).reshape(t, hq * d), a["o"])
                mine = moe(_rms(x, lp["moe_norm"], c["rms_eps"]), lp, c,
                           None if routes is None else routes[b][i])
                picks[b].append(mine["pick"])
                margins[b].append(mine["margin"])
                nulls[b].append(mine["nulls"])
                xs[b] = x + mine["y"]
            del lp
        fin = self._cast({"norm": self.p["norm"], "head": self.p["head"]})
        logprobs = [torch.log_softmax(_rms(x[-tail:], fin["norm"], c["rms_eps"])
                                      @ fin["head"]["w"], dim=-1) for x in xs]
        return {"logprobs": logprobs, "pick": [torch.stack(p) for p in picks],
                "margin": [torch.stack(m) for m in margins],
                "nulls": [torch.stack(n) for n in nulls]}


def route_mismatch(routes: Sequence[torch.Tensor], picks: Sequence[torch.Tensor],
                   margins: Sequence[torch.Tensor],
                   min_margin: float) -> Tuple[int, int, float]:
    """(decisions whose routed set differs from the reference's own pick,
    decisions compared, the widest margin of any decision that differs):
    the first two over every clip, layer and token whose margin is above
    `min_margin`, the third over all of them (0 where none differs)."""
    bad = seen = 0
    widest = 0.0
    for r, p, m in zip(routes, picks, margins):
        got = torch.stack([route_mask(layer.to(p.device)) for layer in r])
        sure = m > min_margin
        bad += int(((got != p) & sure).sum())
        seen += int(sure.sum())
        if (got != p).any():
            widest = max(widest, float(m[got != p].max()))
    return bad, seen, widest
