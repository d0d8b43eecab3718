"""A mixture of experts with null and shared experts (Uni-MoE-2.0-Omni's
decoder MLP), on packed rows.

For rows x after the layer's RMSNorm (fp32):

    p = softmax(x @ W_r)           fp32, over the routed experts then the
                                   null ones
    keep, in p's descending order, the shortest prefix whose sum reaches
    `top_p`, and at most `top_k` entries
    y = sum over kept routed e of p_e * E_e(x) + sum over shared s of S_s(x)

with E and S SwiGLU experts (`layers.SwiGLU`) and no renormalisation of
the kept probabilities; a kept null expert adds nothing. Each routed
expert runs once on the rows routed to it: the (row, pick) pairs are
sorted by expert, the rows gathered, each expert's SwiGLU applied to its
contiguous block (through `layers.linear`, so a block of many rows on the
card takes the fused kernel), and the products added back to their rows
with their weights in fp32 (a scatter-add). The layer is told which
routed experts it holds (`held`): it routes over all of them and computes
the part of the result that its own give, as one rank of expert
parallelism would; on one card it holds all.

The host reads each layer's rows per expert once (one small copy), to cut
the blocks; the counters below add up what it read. They are module-level
ints, as the kernels' `launches` are: callers read them before and after
a slice of work, or set them to 0.

    tokens           rows through a MoE layer, summed over layers
    rows_routed      (row, pick) pairs computed by held routed experts
    null_picks       picks of a null expert
    max_expert_rows  the most rows one held expert took in one layer
    unfused_rows     of rows_routed, those whose expert's products ran
                     outside the fused kernel (`layers.takes_fused`)
    unfused_tokens   of tokens, those whose shared experts' products ran
                     outside the fused kernel

Spans (`utils/profiling.py`): `moe` over the layer, and inside it
`moe.router`, `moe.permute`, `moe.experts`, `moe.shared`, `moe.combine`.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate, spanned
from .layers import SwiGLU, frozen, layer_slice, takes_fused

tokens = 0
rows_routed = 0
null_picks = 0
max_expert_rows = 0
unfused_rows = 0
unfused_tokens = 0

COUNTERS = ("tokens", "rows_routed", "null_picks", "max_expert_rows", "unfused_rows",
            "unfused_tokens")
_LOCK = threading.Lock()


def read_counters() -> dict:
    """The counters' values, by name."""
    with _LOCK:
        return {name: globals()[name] for name in COUNTERS}


def reset_counters() -> None:
    with _LOCK:
        for name in COUNTERS:
            globals()[name] = 0


def _count(n_tokens: int, rows: int, nulls: int, most: int, unfused: int,
           unfused_shared: int) -> None:
    global tokens, rows_routed, null_picks, max_expert_rows, unfused_rows, unfused_tokens
    with _LOCK:
        tokens += n_tokens
        rows_routed += rows
        null_picks += nulls
        max_expert_rows = max(max_expert_rows, most)
        unfused_rows += unfused
        unfused_tokens += unfused_shared


def route(probs: torch.Tensor, top_p: float, top_k: int,
          n_experts: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-p pick over (N, n_routes) probabilities, routed experts first
    and null ones after them: (ids, weights, null), each (N, top_k) in
    descending order of probability. ids are the kept routed experts (-1
    for a slot not kept or kept by a null expert), weights their
    probabilities (0 elsewhere), null marks the kept null experts. An entry
    is kept while the probabilities before it sum to less than `top_p`."""
    p, order = probs.sort(dim=-1, descending=True)
    p, order = p[:, :top_k], order[:, :top_k]
    before = F.pad(p[:, :-1].cumsum(dim=-1), (1, 0))
    keep = before < top_p
    null = keep & (order >= n_experts)
    take = keep & ~null
    return torch.where(take, order, -1), torch.where(take, p, 0.0), null


class MoE(nn.Module):
    """One layer's router, held routed experts and shared experts. `p`
    holds "router" {"w": (hidden, n_routes)}, kept in fp32, and "experts" /
    "shared", SwiGLU trees stacked on axis 0 (float "w" or int8 "w_q" and
    "scale" leaves). `dtype`: the experts' activation dtype."""

    def __init__(self, p: Mapping[str, Any], cfg, dtype: torch.dtype,
                 held: Optional[Iterable[int]] = None):
        super().__init__()
        self.n_experts, self.top_p, self.top_k = cfg.n_experts, cfg.top_p, cfg.top_k
        self.dtype = dtype
        self.router = frozen(p["router"]["w"].float())
        self.held = tuple(range(cfg.n_experts) if held is None else sorted(set(held)))
        # the sort key of a pick: its expert if held, else n_experts (last)
        mask = torch.zeros(cfg.n_experts + 1, dtype=torch.bool)
        mask[list(self.held)] = True
        self.register_buffer("held_mask", mask.to(self.router.device), persistent=False)
        self.experts = nn.ModuleList(SwiGLU(layer_slice(p["experts"], e)) for e in self.held)
        self.shared = nn.ModuleList(SwiGLU(layer_slice(p["shared"], s))
                                    for s in range(cfg.n_shared))

    @spanned("moe")
    def forward(self, x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x32 (N, hidden) fp32 normed rows -> (y (N, hidden) fp32, routes
        (N, top_k) int8: the routed experts picked, -1 for none or null)."""
        n, k, e_all = x32.shape[0], self.top_k, self.n_experts
        x = x32.to(self.dtype)
        with annotate("moe.router"):
            probs = torch.softmax(x32 @ self.router, dim=-1)
            ids, w, null = route(probs, self.top_p, k, e_all)
            key = ids.reshape(-1)
            key = torch.where(key >= 0, key, e_all)
            key = torch.where(self.held_mask[key], key, e_all)
            stats = torch.cat([torch.bincount(key, minlength=e_all + 1)[:e_all],
                               null.sum().view(1)]).tolist()
            counts, nulls = stats[:e_all], stats[e_all]
        total = sum(counts)
        with annotate("moe.permute"):
            order = torch.argsort(key, stable=True)[:total]
            rows = torch.div(order, k, rounding_mode="floor")
            xs = x.index_select(0, rows)
            ws = w.reshape(-1).index_select(0, order)
        ys, unfused, off = [], 0, 0
        with annotate("moe.experts"):
            for j, e in enumerate(self.held):
                # the held experts' blocks follow each other in expert order
                c = counts[e]
                if c:
                    block = xs[off:off + c]
                    if not takes_fused(block, self.experts[j].gate_up):
                        unfused += c
                    ys.append(self.experts[j](block))
                off += c
        with annotate("moe.shared"):
            y = torch.zeros(n, x32.shape[1], dtype=torch.float32, device=x32.device)
            for s in self.shared:
                y.add_(s(x))
        with annotate("moe.combine"):
            if ys:
                y.index_add_(0, rows, (ys[0] if len(ys) == 1 else torch.cat(ys)) * ws[:, None])
        shared_unfused = n if self.shared and not takes_fused(x, self.shared[0].gate_up) else 0
        _count(n, total, nulls, max((counts[e] for e in self.held), default=0), unfused,
               shared_unfused)
        return y, ids.to(torch.int8)
