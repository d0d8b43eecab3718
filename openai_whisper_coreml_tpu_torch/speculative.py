"""Speculative decoding: a cheap draft model proposes K tokens, the target
verifies them in one multi-token decoder step (port of `speculative.py`).

Greedy scheme (token-exact against the plain greedy loop):
  * the carried target logits give this iteration's first token g (argmax
    after the logit rules, the plain loop's);
  * the draft decodes K single-token steps from g, proposing d_1..d_K under
    the same rules, and one more step consuming d_K, so its cache never
    falls behind the commit pointer;
  * the target runs one `decode_step` over [g, d_1..d_K] (T = K+1) at
    per-row positions, and the acceptance walk keeps the longest prefix
    where the target's rules-greedy choice equals the proposal; the first
    mismatch position's target logits are carried, so the correction token
    is committed at the next iteration's first step.

Sampled scheme (temperature > 0): rejection sampling (Leviathan et al.).
The draft samples d_j from its tempered, rule-filtered distribution q_j
with the plain loop's noise at (row, position); the walk accepts d_j with
probability min(1, p_j(d_j) / q_j(d_j)) using a uniform from a tagged
stream (tag 2); the first rejection carries the residual
log(max(p_j - q_j, 0)), from which the next iteration commits with a
second tagged stream (tag 1). The committed sequence is distributed as the
plain sampled loop's; with draft == target nothing is rejected and the
output is seed-exact against it. JAX draws with threefry, the port from
its counter-based hash (`decoding.gumbel_noise`), so the two packages
agree in distribution only.

On the card the draft's single-token steps run the decode kernels: K6 over
its int8 cross-KV and K3 over its bf16 self-cache. The verify step (T > 1)
attends in plain PyTorch, as JAX's does in XLA. Every row accepts its own
prefix length, so rows sit at per-row positions; the buffer and the caches
keep K+1 columns of slack for the candidate writes.

`SpecGovernor` withholds the draft while measured acceptance sits below
the break-even tokens per iteration, from a prior measured on the H100
(`_KINETICS`, `tools/torch_spec_time.py`) until its own walled decodes
calibrate the ratio at the live geometry.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .config import WhisperConfig
from .decoding import _apply_logit_rules, gumbel_noise, uniform_noise
from .models import decoder as dec_mod


def check_pair(cfg: WhisperConfig, cfg_d: WhisperConfig) -> None:
    """A draft is usable iff the two models share the token space."""
    for f in ("n_vocab", "eot_token", "sot_token", "timestamp_begin",
              "no_speech_token", "lang_token_start", "n_langs",
              "multilingual"):
        a, b = getattr(cfg, f), getattr(cfg_d, f)
        if a != b:
            raise ValueError(
                f"draft/target token spaces differ: {f} {b} vs {a} "
                "(speculative decoding needs a shared tokenizer)")


def spec_decode_core(
    decoder: dec_mod.TextDecoder,
    decoder_d: dec_mod.TextDecoder,
    audio_features: torch.Tensor,  # (B, S, n_state): the target's encoder output
    audio_features_d: torch.Tensor,  # the draft decoder's (often the same tensor)
    initial_tokens: torch.Tensor,  # (B, P) left-padded to the P bucket
    suppress_mask: torch.Tensor,  # (V,) bool
    blank_mask: torch.Tensor,  # (V,) bool
    max_initial_ts_index: int,  # -1 disables
    pad_len: Union[int, torch.Tensor],  # int or (B,)
    sot_index: Union[int, torch.Tensor],  # int or (B,)
    *,
    sample_len: int,
    use_timestamps: bool,
    prompt_len: int,
    spec_k: int,
    kv_dtype: str = "bf16",
    sampled: bool = False,
    temperature: float = 0.0,
    seed: int = 0,
    row0: int = 0,  # the batch's first row in the whole batch (the noise's row)
) -> Tuple[torch.Tensor, ...]:
    """Speculative decode. Returns (tokens (B, P+sample_len), sum_lp,
    n_sampled, no_speech_prob, n_iters (B,), n_drafted (B,)).

    n_iters counts verify steps while the row was live; n_drafted the draft
    proposals offered (spec_k * n_iters), so the acceptance rate per offered
    token is (n_sampled - n_iters) / n_drafted. The caller keeps
    prompt_len + sample_len + spec_k + 1 within the text context."""
    cfg, cfg_d = decoder.cfg, decoder_d.cfg
    dev = audio_features.device
    b = audio_features.shape[0]
    eot = cfg.eot_token
    ts_begin = cfg.timestamp_begin
    k = spec_k
    total_len = prompt_len + sample_len
    # candidate writes overshoot the committed horizon by up to K columns
    buf_len = total_len + k + 1
    cache_len = min(-(-buf_len // 128) * 128, cfg.n_text_ctx)
    rows = torch.arange(b, device=dev)
    t_div = max(temperature, 1e-6)

    cross_t = dec_mod.precompute_cross(decoder, audio_features, kv_dtype)
    cross_d = dec_mod.precompute_cross(decoder_d, audio_features_d, kv_dtype)
    cache_t = dec_mod.init_kv_cache(cfg, b, audio_features.dtype, dev,
                                    ctx=cache_len, n_head=decoder.n_head)
    cache_d = dec_mod.init_kv_cache(cfg_d, b, audio_features_d.dtype, dev,
                                    ctx=cache_len, n_head=decoder_d.n_head)
    self_kernel_d = dec_mod.use_self_kernel(cache_d)
    pad_len = torch.as_tensor(pad_len, device=dev)

    initial_tokens = initial_tokens.to(device=dev, dtype=torch.long)
    tokens = torch.full((b, buf_len), eot, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = initial_tokens

    # prompt prefill for both models (the draft carries the same context)
    prefill_t, cache_t = dec_mod.decode_step(
        decoder, initial_tokens, cross_t, cache_t, 0, valid_from=pad_len)
    _, cache_d = dec_mod.decode_step(
        decoder_d, initial_tokens, cross_d, cache_d, 0, valid_from=pad_len)
    si = torch.as_tensor(sot_index, device=dev).expand(b)
    no_speech_prob = torch.softmax(prefill_t[rows, si], dim=-1)[
        :, cfg.no_speech_token]

    def rules(logits, pos, ts):
        return _apply_logit_rules(
            logits, tokens, pos, cfg, prompt_len, suppress_mask, blank_mask,
            use_timestamps, ts, max_initial_ts_index)

    def draw(scaled_or_res, pos, tag=None):
        noise = gumbel_noise(seed, rows + row0, pos, cfg.n_vocab, tag)
        return (scaled_or_res + noise).argmax(dim=-1)

    def pick(x, idx):
        return x.gather(1, idx[:, None])[:, 0]

    # finished rows idle at pos <= total_len; the K+1 columns of slack keep
    # their (gated) accesses in bounds, so pos is never clamped: a clamp
    # would move a finished row's pointer and the cleanup would wipe its
    # last token
    pos = torch.full((b,), prompt_len, dtype=torch.long, device=dev)
    logits = prefill_t[:, -1].float()
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    n_sampled = torch.zeros(b, dtype=torch.long, device=dev)
    ts_max = torch.full((b,), ts_begin - 1, dtype=torch.long, device=dev)
    n_iters = torch.zeros(b, dtype=torch.long, device=dev)
    carried_res = torch.zeros((b, cfg.n_vocab), dtype=torch.float32, device=dev)
    ready = torch.zeros(b, dtype=torch.bool, device=dev)
    while True:
        # -- 1) commit g, the token the carried target logits give --------
        filt = rules(logits, pos, ts_max)
        if sampled:
            # ready rows commit from the carried residual with a tagged
            # stream (fresh randomness); the others as the plain loop does
            g = draw(filt / t_div, pos)
            if bool(ready.any()):
                g = torch.where(ready, draw(carried_res, pos, tag=1), g)
        else:
            g = filt.argmax(dim=-1)
        lp_g = pick(torch.log_softmax(filt, dim=-1), g)
        g = torch.where(finished, eot, g)
        tokens[rows, pos] = torch.where(finished, tokens[rows, pos], g)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp_g)
        n_sampled = n_sampled + (~finished).long()
        ts_max = torch.where((g >= ts_begin) & ~finished, g, ts_max)
        fin_g = finished | (g == eot) | (pos + 1 >= total_len)

        # -- 2) the draft proposes d_1..d_K ------------------------------
        d_ts, d_tok, d_pos = ts_max, g, pos
        d_list, q_list = [], []
        for _ in range(k):
            d_logits, cache_d = dec_mod.decode_step(
                decoder_d, d_tok[:, None], cross_d, cache_d, d_pos,
                valid_from=pad_len, self_kernel=self_kernel_d)
            d_filt = rules(d_logits[:, 0].float(), d_pos + 1, d_ts)
            if sampled:
                q_list.append(torch.softmax(d_filt / t_div, dim=-1))
                d_next = draw(d_filt / t_div, d_pos + 1)
            else:
                d_next = d_filt.argmax(dim=-1)
            # the proposal lands in the buffer now: the rules at position
            # pos+j+1 read tokens[pos+j]; a rejected tail stays above the
            # row's pointer until later candidates or the cleanup clear it
            tokens[rows, d_pos + 1] = torch.where(fin_g, tokens[rows, d_pos + 1],
                                                  d_next)
            d_ts = torch.where(d_next >= ts_begin, d_next, d_ts)
            d_list.append(d_next)
            d_tok, d_pos = d_next, d_pos + 1
        # consume d_K too, so the draft cache never falls behind the commit
        # pointer even when every proposal is accepted (logits unused)
        _, cache_d = dec_mod.decode_step(
            decoder_d, d_tok[:, None], cross_d, cache_d, d_pos,
            valid_from=pad_len, self_kernel=self_kernel_d)

        # -- 3) verify: one target step over K+1 tokens ------------------
        v_logits, cache_t = dec_mod.decode_step(
            decoder, torch.stack([g] + d_list, dim=1), cross_t, cache_t, pos,
            valid_from=pad_len)
        # v_logits[:, j] predicts position pos+j+1 given candidates <= pos+j

        # -- 4) the acceptance walk --------------------------------------
        acc = torch.zeros(b, dtype=torch.long, device=dev)
        accepting = ~fin_g
        eot_hit = (g == eot) & ~finished
        w_ts = ts_max
        new_res, new_ready = carried_res, torch.zeros_like(ready)
        for j, d_j in enumerate(d_list):
            filt_j = rules(v_logits[:, j].float(), pos + j + 1, w_ts)
            if sampled:
                p_j = torch.softmax(filt_j / t_div, dim=-1)
                q_j = q_list[j]
                u = uniform_noise(seed, rows + row0, pos + j + 1, tag=2)
                # u*q < p  <=>  u < p/q (q(d_j) > 0: d_j was drawn from q_j)
                match = accepting & (u * pick(q_j, d_j) < pick(p_j, d_j))
                rej = accepting & ~match
                # p == q exactly makes a rejection impossible; guard the
                # empty residual of a floating-point tie with p itself
                has_mass = (p_j > q_j).any(dim=-1, keepdim=True)
                res_j = _log_residual(torch.where(has_mass, p_j - q_j, p_j),
                                      has_mass)
                new_res = torch.where(rej[:, None], res_j, new_res)
                new_ready = new_ready | rej
            else:
                match = accepting & (filt_j.argmax(dim=-1) == d_j)
            lp_j = pick(torch.log_softmax(filt_j, dim=-1), d_j)
            sum_lp = sum_lp + torch.where(match, lp_j, 0.0)
            n_sampled = n_sampled + match.long()
            w_ts = torch.where(match & (d_j >= ts_begin), d_j, w_ts)
            acc = acc + match.long()
            eot_hit = eot_hit | (match & (d_j == eot))
            accepting = match & (d_j != eot) & (pos + j + 2 < total_len)
        ts_max = w_ts

        # -- 5) advance --------------------------------------------------
        new_pos = torch.where(finished, pos, pos + acc + 1)
        logits = torch.where(finished[:, None], logits,
                             v_logits[rows, acc].float())
        n_iters = n_iters + (~finished).long()
        finished = finished | eot_hit | (new_pos >= total_len)
        pos = new_pos
        if sampled:
            carried_res, ready = new_res, new_ready & ~finished
        if bool(finished.all()):
            break

    # clear the rejected-candidate tail above each row's commit pointer
    col = torch.arange(buf_len, device=dev)[None, :]
    tokens = torch.where(col >= pos[:, None], eot, tokens)
    return (tokens[:, :total_len], sum_lp, n_sampled, no_speech_prob,
            n_iters, n_iters * k)


_FLT_TINY = torch.finfo(torch.float32).tiny
_LOG_1E_38 = float(np.log(np.float32(1e-38)))


def _log_residual(x: torch.Tensor, has_mass: torch.Tensor) -> torch.Tensor:
    """JAX's residual logits: log(max(p - q, 0)) where the residual has
    mass, log(max(p, 1e-38)) where it has none (x holds p - q or p).
    log is taken of normal numbers only (a zero or a denormal takes the
    CPU's slow path, ~20x); a positive entry below fp32's smallest normal
    counts as that normal."""
    logs = x.clamp(min=_FLT_TINY).log_()
    return torch.where(x > 0, logs, torch.where(has_mass, -torch.inf, _LOG_1E_38))


def draft_features(model, draft, mel: Optional[torch.Tensor],
                   feats: torch.Tensor) -> torch.Tensor:
    """The draft decoder's feature input: the target's features when the
    encoders have the same width and context (the turbo pairing: its
    decoder was distilled against the frozen large-v3 encoder), else the
    draft's own encoder over the same mel."""
    if (draft.cfg.n_audio_state == model.cfg.n_audio_state
            and draft.cfg.n_audio_ctx == model.cfg.n_audio_ctx):
        return feats
    if mel is None:
        raise ValueError(
            "draft encoder width differs from the target's; speculative "
            "decoding from precomputed features needs a width-matched "
            "draft (pass mel instead)")
    return draft.encode(mel)


# diagnostics: decoding.decode stores the most recent speculative decode's
# aggregate stats here (tokens per iteration, acceptance rate), from any
# thread; read by tools; never part of DecodingResult
LAST_STATS: Optional[dict] = None

# process-lifetime accumulation (same producer): serve_http's batch worker
# diffs it around each batch for its /metrics counters and gauges. The
# server's handler threads decode too, so updates take a lock.
TOTALS = {"iters": 0, "tokens": 0, "drafted": 0}
_TOTALS_LOCK = threading.Lock()


def accumulate_stats(stats: dict) -> None:
    with _TOTALS_LOCK:
        TOTALS["iters"] += stats["iters"]
        TOTALS["tokens"] += stats["tokens"]
        TOTALS["drafted"] += stats["drafted"]


def spec_stats(n_sampled: np.ndarray, n_iters: np.ndarray,
               n_drafted: np.ndarray) -> dict:
    """Aggregate acceptance statistics for logging and benchmarks."""
    n_sampled = np.asarray(n_sampled, np.float64)
    n_iters = np.maximum(np.asarray(n_iters, np.float64), 1)
    n_drafted = np.maximum(np.asarray(n_drafted, np.float64), 1)
    return {
        "tokens_per_iter": float(np.sum(n_sampled) / np.sum(n_iters)),
        "acceptance_rate": float(np.sum(n_sampled - n_iters)
                                 / np.sum(n_drafted)),
        "iters": int(np.sum(n_iters)),
        "tokens": int(np.sum(n_sampled)),
        "drafted": int(np.sum(n_drafted)),
    }


# -- acceptance governor: automatic draft fallback for serving ---------------

# The iteration-cost prior, measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by tools/torch_spec_time.py (--sample-len 48
# --repeats 5): large-v3 target with int8 weights, int8 cross-KV and a
# bf16 self-cache, a large-v3-turbo draft of the same kind; walls end once
# the tokens are on the host. Per batch: (iter_ms_base, iter_ms_per_k,
# plain_ms_per_token), ms/iteration = base + per_k * K being the line
# through the medians at K = 4 and K = 8, and plain ms/token the plain
# greedy loop's median. Both costs are host-bound on the card, so the
# break-even sits near 2.4-2.9 tokens/iteration at K = 4 at every batch,
# and the walls move with the host by up to ~30% (PERF.md). Only the
# prior: SpecGovernor calibrates from walled decodes at its own geometry.
_KINETICS = {
    1: (80.74, 7.162, 41.34),
    8: (99.21, 11.97, 55.12),
    16: (112.15, 6.986, 47.92),
    24: (101.36, 15.08, 67.70),
    32: (108.15, 12.45, 62.15),
}


def break_even_tokens_per_iter(k: int, batch: int = 24) -> float:
    """Tokens per iteration below which a speculative iteration costs more
    than decoding the same tokens with the plain loop, from the calibration
    geometry nearest (in log batch) to ``batch``."""
    lb = math.log(max(int(batch), 1))
    cal = min(_KINETICS, key=lambda b: abs(lb - math.log(b)))
    base, slope, tok = _KINETICS[cal]
    return (base + slope * k) / tok


# most recent decode-core wall, set by decoding.decode on every call:
# {"path": "spec"|"plain", "wall_s", "units", "batch", "k", "temperature"},
# units being the max row's iterations (spec) or committed tokens (plain):
# the loop runs until its slowest row finishes. None when the call took a
# path of other kinetics (beam, best_of fan-out).
LAST_TIMING: Optional[dict] = None

# the same two records for the calling thread's own decodes: the server's
# batch worker and its /stream handlers decode at once, and each governor
# observes only the decodes it ran
_THREAD = threading.local()


def publish(stats: Optional[dict], timing: Optional[dict]) -> None:
    """decoding.decode's record of one decode: its speculative stats (None
    for a plain decode; else LAST_STATS, added to TOTALS) and its
    LAST_TIMING, module-wide and for the calling thread."""
    global LAST_STATS, LAST_TIMING
    if stats is not None:
        LAST_STATS = stats
        accumulate_stats(stats)
    LAST_TIMING = timing
    _THREAD.stats, _THREAD.timing = stats, timing


def governed_decode(gov: Optional["SpecGovernor"], draft, decode_fn,
                    sampled: bool = False):
    """decode_fn(draft) with the draft unless the governor withholds it from
    this regime (decode_fn(None) then runs the plain loop); the governor
    takes this decode's acceptance and its wall, plain walls included. With
    no governor (spec_fallback off) the draft runs ungoverned. It reads
    this thread's records, so another thread's decode in between does not
    reach the governor."""
    if gov is not None and draft is not None and not gov.permit(sampled=sampled):
        draft = None
    _THREAD.stats = _THREAD.timing = None  # observe only this decode
    result = decode_fn(draft)
    if gov is not None:
        if draft is not None:
            gov.observe(_THREAD.stats, sampled=sampled)
        gov.observe_timing(_THREAD.timing)
    return result


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class SpecGovernor:
    """Withhold the draft while measured acceptance sits below break-even.

    Acceptance is a property of the content and the model pair: noise,
    music or domain shift can push draft agreement below the break-even
    where a speculative iteration costs more than the plain steps it
    replaces. The governor keeps tokens per iteration over a sliding window
    of decode batches and withholds the draft while the windowed mean is
    below the threshold; every ``reprobe_every``-th withheld batch runs
    speculatively anyway, so a recovery re-enables the draft.

    The threshold calibrates itself: decoding.decode walls every decode
    core (LAST_TIMING), and ``observe_timing`` keeps windowed medians of
    speculative ms per iteration, bucketed by (batch, K, sampled), and
    plain ms per token, bucketed by batch. Once the most recent spec
    geometry's bucket and the plain bucket of its batch each hold
    ``calib_min_obs`` walls, the threshold is their ratio; before that it
    is the constructor's prior. Medians keep a first wall that builds
    kernels from skewing the estimate. The walls include each call's setup
    (cross-KV and prefill), which weighs more per unit on the speculative
    side, so the live threshold sits slightly high: the cheap direction.
    ``pinned=True`` (an explicit user threshold) disables calibration.

    Evidence is kept per regime: greedy argmax verification and t > 0
    rejection sampling (``sampled=True``) each have their own window,
    verdict and reprobe counter. ``disabled`` and ``tokens_per_iter``
    expose the greedy regime; ``disabled_sampled`` the other.

    Not thread-safe: one governor per serving batch worker, per transcribe
    call or per stream.
    """

    def __init__(self, threshold: float, min_iters: int = 32,
                 window: int = 8, reprobe_every: int = 8,
                 pinned: bool = False, calib_window: int = 16,
                 calib_min_obs: int = 3):
        if threshold <= 1.0:
            raise ValueError(
                f"threshold must exceed 1.0 tokens/iter, got {threshold}")
        self.prior_threshold = float(threshold)
        self.pinned = bool(pinned)
        self.min_iters = int(min_iters)  # evidence mass before any verdict
        self.window = int(window)  # observations in the sliding window
        self.reprobe_every = int(reprobe_every)
        self.calib_window = int(calib_window)
        self.calib_min_obs = int(calib_min_obs)
        # per-regime acceptance state, keyed by sampled
        self._obs = {False: [], True: []}  # [(tokens, iters), ...]
        self._skips = {False: 0, True: 0}
        self._disabled = {False: False, True: False}
        # walls bucketed by geometry (timings without batch/k share one
        # None bucket, which is still self-consistent)
        self._iter_ms: dict = {}  # (batch, k, sampled) -> [ms/iter, ...]
        self._tok_ms: dict = {}  # batch -> [ms/token, ...]
        self._geom = {False: None, True: None}  # newest spec (batch, k, s)
        self._tok_geom = None  # newest plain batch

    @property
    def disabled(self) -> bool:
        return self._disabled[False]

    @disabled.setter
    def disabled(self, value: bool) -> None:
        self._disabled[False] = bool(value)

    @property
    def disabled_sampled(self) -> bool:
        return self._disabled[True]

    @property
    def tokens_per_iter(self) -> Optional[float]:
        iters = sum(i for _, i in self._obs[False])
        if iters == 0:
            return None
        return sum(t for t, _ in self._obs[False]) / iters

    # -- live kinetics calibration -------------------------------------------

    def _iter_list(self, sampled: bool) -> Optional[list]:
        key = self._geom[sampled]
        return None if key is None else self._iter_ms.get(key)

    def _tok_list(self, sampled: bool) -> Optional[list]:
        key = self._geom[sampled]
        batch = key[0] if key is not None else self._tok_geom
        return self._tok_ms.get(batch)

    @property
    def live_iter_ms(self) -> Optional[float]:
        walls = self._iter_list(False)
        return _median(walls) if walls else None

    @property
    def live_tok_ms(self) -> Optional[float]:
        walls = self._tok_list(False)
        return _median(walls) if walls else None

    def _calibrated(self, sampled: bool) -> bool:
        if self.pinned:
            return False
        iters, toks = self._iter_list(sampled), self._tok_list(sampled)
        return (iters is not None and len(iters) >= self.calib_min_obs
                and toks is not None and len(toks) >= self.calib_min_obs)

    @property
    def calibrated(self) -> bool:
        return self._calibrated(False)

    def _threshold_for(self, sampled: bool) -> float:
        if self._calibrated(sampled):
            # a threshold <= 1 can never be failed (tpi >= 1 always): floor
            # it just above, so a degenerate calibration cannot lock the
            # draft on
            return max(1.0 + 1e-6, _median(self._iter_list(sampled))
                       / _median(self._tok_list(sampled)))
        return self.prior_threshold

    @property
    def threshold(self) -> float:
        """Break-even tokens per iteration: live once calibrated, else the
        prior."""
        return self._threshold_for(False)

    def observe_timing(self, timing: Optional[dict]) -> None:
        """Feed one decode's LAST_TIMING (None-safe). Spec walls calibrate
        ms per iteration, plain walls (withheld batches, best_of-free t > 0
        rungs) ms per token, each in the bucket of its own geometry, so a
        remainder chunk at another batch never enters the serving batch's
        ratio."""
        if self.pinned or not timing or timing.get("units", 0) <= 0:
            return
        per_unit = timing["wall_s"] * 1e3 / timing["units"]
        if timing.get("path") == "spec":
            sampled = bool(timing.get("temperature") or 0.0)
            key = (timing.get("batch"), timing.get("k"), sampled)
            self._geom[sampled] = key
            dest = self._iter_ms.setdefault(key, [])
        elif timing.get("path") == "plain":
            batch = timing.get("batch")
            self._tok_geom = batch
            dest = self._tok_ms.setdefault(batch, [])
        else:
            return
        dest.append(per_unit)
        if len(dest) > self.calib_window:
            del dest[: len(dest) - self.calib_window]

    def permit(self, sampled: bool = False) -> bool:
        """Should the next decode batch of this regime use the draft?"""
        if not self._disabled[sampled]:
            return True
        self._skips[sampled] += 1
        if self._skips[sampled] >= self.reprobe_every:
            self._skips[sampled] = 0
            return True  # probe batch: has acceptance recovered?
        return False

    def observe(self, stats: Optional[dict], sampled: bool = False) -> None:
        """Feed one decode batch's LAST_STATS (None-safe: a decode that took
        the plain path contributes nothing) to its regime's window."""
        if not stats or stats.get("iters", 0) <= 0:
            return
        obs = self._obs[sampled]
        obs.append((stats["tokens"], stats["iters"]))
        if len(obs) > self.window:
            del obs[: len(obs) - self.window]
        iters = sum(i for _, i in obs)
        if iters >= self.min_iters:
            tpi = sum(t for t, _ in obs) / iters
            was = self._disabled[sampled]
            self._disabled[sampled] = tpi < self._threshold_for(sampled)
            if self._disabled[sampled] and not was:
                # the evidence that withheld the draft would keep withholding
                # it on every probe: probes start from an empty window
                self._obs[sampled] = []
                self._skips[sampled] = 0
