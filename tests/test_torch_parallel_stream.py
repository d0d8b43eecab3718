"""The two stream classes under the port's DP x TP mesh against JAX's
one-process events, on gloo ranks spawned on the CPU (fp32, the same
weights).

Each tick's decode goes through `decode`, which splits the rows over the
data groups and gathers the tokens on every rank, so every rank runs the
same stream state machine and must emit JAX's events (text, tokens,
is_final), as `test_torch_stream.py` holds the one-process port: through
confirmation, a trim with its dedup, per-stream conditioning and
`finish`, plain and with the model as its own draft (greedy speculative
tokens are the plain ones), the draft's governor pinned under the mesh."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import stream as jst
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

from . import torch_parallel_worker as worker
from .test_torch_stream import _tone

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 1)]
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights and audio, written for the ranks, and JAX's events."""
    d = tmp_path_factory.mktemp("stream")
    cfg = jax_tiny(**worker.SERVE_SIZE)
    params = jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(2)))
    np.savez(d / "serve_params.npz", **flatten_params(params))
    audio = {name: _tone(seconds, 0) for name, (seconds, _) in worker.STREAM_CASES.items()}
    multi = [_tone(6, 1), _tone(4, 2, hz=260)]
    np.savez(d / "stream_inputs.npz", m0=multi[0], m1=multi[1], **audio)
    jm = JaxModel(cfg=cfg, params=params)
    want = {name: worker.run_stream(jst.StreamingTranscriber(jm, language="en", **kw),
                                    audio[name])
            for name, (_, kw) in worker.STREAM_CASES.items()}
    want["multi"] = worker.run_multistream(jst.MultiStreamTranscriber(jm, **worker.MULTI_KW),
                                           multi)
    return {"dir": str(d), "want": want}


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def ranks(request, setup):
    n_data, n_model = request.param
    return worker.spawn(n_data * n_model, worker.stream_checks, n_data, n_model,
                        setup["dir"])


@pytest.mark.parametrize("case", list(worker.STREAM_CASES))
def test_streaming_events_equal_jax_on_every_rank(ranks, setup, case):
    want = setup["want"][case]
    assert want[-1][2] is True and any(tokens for _, tokens, _ in want)
    for res in ranks:
        assert res[case] == want


def test_multistream_events_equal_jax_on_every_rank(ranks, setup):
    want = setup["want"]["multi"]
    assert all(evs[-1][2] is True for evs in want.values())
    for res in ranks:
        assert res["multi"] == want


def test_self_drafted_streams_equal_jax_with_a_pinned_governor(ranks, setup):
    """With the model as its own draft both classes stream JAX's plain
    events, and their governors keep the prior threshold (walls differ
    between ranks)."""
    for res in ranks:
        assert res["draft"] == setup["want"]["agreement-2"]
        assert res["multi_draft"] == setup["want"]["multi"]
        assert res["draft_pinned"] and res["multi_draft_pinned"]


def test_cli_stream_prints_once_under_tensor_parallel(tmp_path, monkeypatch):
    """`cli --stream --tensor-parallel 2`: both ranks stream, rank 0 alone
    prints, and it prints what the one-process CLI prints."""
    from openai_whisper_coreml_tpu_torch.utils import audio_io

    wav = str(tmp_path / "clip.wav")
    audio_io.save_wav(wav, _tone(4, 5), 16000)
    args = [wav, "--stream", "--language", "en"]
    want = worker.cli_capture(args)
    got = worker.spawn(2, worker.cli_capture, args + ["--tensor-parallel", "2"])
    assert want[0].strip() and got[0][0] == want[0]
    assert "streamed" in got[0][1]
    assert got[1] == ("", "")
