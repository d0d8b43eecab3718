"""The Uni-MoE family (`families/unimoe.py`, `traffic/audio_prompt_batches.py`,
`reference/unimoe.py`) at a tiny size on the CPU: a whole run of
`omni-audio-langid` comes out `correct`, a program with two experts'
weights swapped, or one that routes at another top-p, comes out not
correct, the control reads wider than the program, and the cell's readers read what they should from a record
built by hand. Tiny sizes, as `test_portbench_families.py` runs its toy
family: hidden 128 (the experts' weights pass the int8 rule's floor),
4 / 2 heads, 2 layers, 4 experts of 256 and a null one, 2 shared of 64,
a vocabulary of 512, a 2-layer encoder at 64."""

from __future__ import annotations

import copy
import subprocess
import sys

import pytest
import torch

from portbench import families, run
from portbench.lib import spec
from portbench.lib.spanned_record import SpannedRecord
from portbench.lib.spans import SpanSlice
from portbench.lib.readers import load_reader
from portbench.lib.trace import Kernel, SliceRecord
from portbench.metrics import unimoe_counts

NAME = "omni-audio-langid"
TINY = dict(
    spec.config_file("uni-moe-2.0-omni"), name="tiny-unimoe", whisper_num_mel_bins=80,
    whisper_hidden_size=64, whisper_encoder_attention_heads=2, whisper_encoder_layers=2,
    whisper_encoder_ffn_dim=256, whisper_query_tokens_size=20, hidden_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
    dynamic_intermediate_size=256, shared_intermediate_size=64)


def tiny_cell(answer_gap: float = 1e-3) -> dict:
    cell = copy.deepcopy(spec.cell_file(NAME))
    # a call holds more clips than the judge draws: a slow host that runs one call in
    # the window still hands it enough
    cell["params"].update(clips_per_call=4, pool_calls=2, traced_calls=1, prefix_tokens=4,
                          question={"median": 6, "sigma": 0.6, "min": 2, "max": 12})
    cell["check"]["clips"] = 3
    cell["check"]["limits"]["answer_gap"] = answer_gap
    return cell


def _run(seed=2**32 + 5):
    return run.run_cell(NAME, seed, 2.0, False, torch.device("cpu"), spec.benchmark(),
                        cell=tiny_cell(), config=copy.deepcopy(TINY), t_start=0.0)


def test_the_cell_runs_correct_on_cpu():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert result["checks"]["answer_gap"]["value"] < 1e-4
    assert result["checks"]["route_mismatch"]["value"] == 0
    assert set(result["metrics"]) == {"langid_rtfx", "setup_s"}


def test_two_experts_swapped_in_the_program_is_not_correct(monkeypatch):
    from openai_whisper_coreml_tpu_torch.models import moe

    init = moe.MoE.__init__

    def swapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.experts[0], self.experts[1] = self.experts[1], self.experts[0]

    monkeypatch.setattr(moe.MoE, "__init__", swapped)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["answer_gap"]["value"] > 1e-2


def test_a_program_that_routes_at_another_top_p_is_not_correct(monkeypatch):
    """The reference runs under the program's routes, so the answer cannot
    see a routing fault: the route comparison must, at the cell's margin."""
    from openai_whisper_coreml_tpu_torch.models import moe

    init = moe.MoE.__init__

    def lower(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.top_p = 0.5

    monkeypatch.setattr(moe.MoE, "__init__", lower)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["answer_gap"]["value"] < 1e-4
    assert result["checks"]["route_mismatch"]["value"] > 0


def test_the_control_reads_wider_than_the_program():
    d = families.of(TINY).dims(TINY)
    ctx, out, _, _ = run.serve_cell(NAME, 7, 2.0, False, torch.device("cpu"),
                                    cell=tiny_cell(), config=copy.deepcopy(TINY), t_start=0.0)
    checks = run.judge_outcome(ctx, out, torch.float32, control=True)
    assert checks["answer_gap"]["value"] < 1e-4 < 1e-2 < checks["control_gap"]["value"]
    assert d["n_vocab"] == 512 and len(out.answers) == 3


def test_every_seed_asks_the_same_question_lengths():
    from portbench.lib.cell import Ctx
    from portbench.traffic import audio_prompt_batches as kind

    def lengths(seed):
        ctx = Ctx(cell=spec.cell_file(NAME), config={}, dims={"n_vocab": 152064}, cfg=None,
                  seed=seed, seconds=0, trace=False, device=None)
        return [len(q) for _, q in kind.prompts(ctx, 256)]

    a, b = lengths(3), lengths(2**33 + 1)
    assert a != b and sorted(a) == sorted(b)
    assert min(a) >= 8 and max(a) <= 136 and 30 <= sorted(a)[128] <= 50


def test_the_published_sizes():
    d = families.of(spec.config_file("uni-moe-2.0-omni")).dims(
        spec.config_file("uni-moe-2.0-omni"))
    cfg = families.load("unimoe").program_config({"name": "x"}, d)
    assert (cfg.hidden, cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim) == \
        (3584, 28, 28, 4, 128)
    assert (cfg.n_experts, cfg.n_null_experts, cfg.expert_ffn, cfg.top_k, cfg.n_shared,
            cfg.shared_ffn, cfg.n_vocab) == (4, 1, 18944, 2, 2, 2368, 152064)
    n = unimoe_counts
    assert n.layer_token_flops(d) == pytest.approx(
        2 * 3584 * (3584 + 1024) + 2 * 3584 * 3584 + 2 * 3584 * 5 + 2 * 6 * 3584 * 2368)


# -- the readers -----------------------------------------------------------------------

def _record(d):
    ms = 1_000_000
    sl = SliceRecord((0, 100 * ms), device=[(0, 10 * ms, "fused_linear_kernel"),
                                            (10 * ms, 20 * ms, "fused_linear_kernel"),
                                            (20 * ms, 30 * ms, "elementwise"),
                                            (40 * ms, 50 * ms, "fused_linear_kernel")],
                     kernels=[Kernel("fa_fwd_bf16_kernel<false>", 0, 1, (1, 1, 4))])
    ss = SpanSlice(sl, spans=[(0, 1, "moe", 0)],
                   chains=[("moe", "moe.experts"), ("moe", "moe.shared"), ("moe",),
                           ("encoder",)])
    return SpannedRecord(d, sl, counters={"moe.tokens": 1000, "moe.rows_routed": 1500},
                         decode={"attn_pairs": 50_000, "clips": 4}, windows=4,
                         spans=ss, span_counters={"moe.tokens": 1000, "moe.rows_routed": 1500,
                                                  "moe.unfused_rows": 500,
                                                  "moe.unfused_tokens": 0},
                         span_windows=4)


def test_readers_by_hand():
    d = families.of(TINY).dims(spec.config_file("uni-moe-2.0-omni"))
    rec = _record(d)
    # the moe span's device time: 30 ms over 4 clips
    assert load_reader("omni.moe_ms_per_window")(rec) == pytest.approx(7.5)
    flops = 1000 * 6 * 3584 * 18944 + 1000 * 2 * 6 * 3584 * 2368
    assert load_reader("moe_roofline.omni")(rec) == pytest.approx(
        100 * flops / 989e12 / 0.020)
    assert load_reader("idle_share.omni")(rec) == pytest.approx(60.0)
    want = unimoe_counts.model_flops(d, 4 / 32, 1000, 1500, 50_000, 4)
    assert load_reader("mfu.omni")(rec) == pytest.approx(100 * want / (0.1 * 989e12))


def test_readers_of_a_program_without_counters_or_spans_read_none():
    d = families.of(TINY).dims(spec.config_file("uni-moe-2.0-omni"))
    rec = _record(d)
    rec.counters, rec.spans, rec.span_counters = {}, None, {}
    for name in ("omni.moe_ms_per_window", "moe_roofline.omni", "mfu.omni"):
        assert load_reader(name)(rec) is None
    assert load_reader("idle_share.omni")(rec) == pytest.approx(60.0)


def test_the_family_and_its_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from portbench import run; "
            "import portbench.families.unimoe, portbench.traffic.audio_prompt_batches, "
            "portbench.reference.unimoe, openai_whisper_coreml_tpu_torch.lm_decoding; "
            "print(run.forbidden_modules())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
