"""The HTTP server under the port's DP x TP mesh, on gloo ranks spawned
on the CPU (fp32): rank 0 serves on a free port and the other ranks run
`serve_http.follow`, executing each model command that rank 0 broadcasts.

Every route's answer (/healthz, /readyz, /transcribe with and without
words, the OpenAI route as verbose_json with words and as srt, /detect,
/stream, two concurrent /transcribe requests) equals the one-process port
server's on the same weights, floats within 1e-5. A request that fails
validation answers 400 and sends no command; a model error raises on
every rank, answers 500, and the next request is served; an idle period
longer than the process group's timeout passes (rank 0's no-ops keep the
followers' broadcast alive); `stop()` returns the followers, which ran
rank 0's commands in rank 0's order."""

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
from openai_whisper_coreml_tpu_torch.params import init_params
from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer
from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

from . import torch_parallel_worker as worker
from .test_torch_wordts import speechy

torch.set_num_threads(1)

PG_TIMEOUT_S = 6.0
IDLE_S = 1.5 * PG_TIMEOUT_S
MESHES = [(1, 2), (2, 2)]
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights and clips, written for the ranks, and the one-process
    server's answers."""
    d = tmp_path_factory.mktemp("server")
    cfg = tiny_test_config(**worker.SERVE_SIZE)
    tree = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
                       device="cpu")
    np.savez(d / "serve_params.npz", **{k: v.numpy() for k, v in
                                        flatten_params(tree).items()})
    clips = [speechy(3, 31), speechy(5, 32)]
    np.savez(d / "server_inputs.npz", c0=clips[0], c1=clips[1])
    srv = WhisperHTTPServer(model_from_params(cfg, tree), port=0, batch_size=2,
                            batch_window_ms=20, default_options=worker.SERVER_DEFAULTS)
    srv.start()
    try:
        want = worker.http_exercise(srv.port, clips)
    finally:
        srv.stop()
    return {"dir": str(d), "want": want}


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def ranks(request, setup):
    """Every rank's result for one mesh; the process group times out a
    collective after PG_TIMEOUT_S, and rank 0 idles IDLE_S once."""
    n_data, n_model = request.param
    return worker.spawn(n_data * n_model, worker.server_checks, n_data, n_model,
                        setup["dir"], IDLE_S, pg_timeout_s=PG_TIMEOUT_S)


def _assert_close(got, want, where="answer"):
    """Equal structure, strings and integers; floats within 1e-5."""
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5), where
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


ROUTES = ["healthz", "readyz", "transcribe", "transcribe_words", "openai_verbose",
          "openai_srt", "detect", "stream", "concurrent", "after_error", "after_idle"]


@pytest.mark.parametrize("route", ROUTES)
def test_routes_answer_as_the_one_process_server(ranks, setup, route):
    got, want = ranks[0][route], setup["want"][route]
    assert all(code == 200 for code, _ in (want if route == "concurrent" else [want]))
    _assert_close(got, want, route)


def test_answers_carry_words_and_text(setup):
    """The one-process answers the mesh is held to are real transcripts:
    words where asked for, stream lines ending final."""
    want = setup["want"]
    assert any(s["words"] for s in want["transcribe_words"][1]["segments"])
    assert want["openai_verbose"][1]["words"]
    assert want["stream"][1][-1]["final"] is True
    assert want["detect"][1]["language"]


def test_bad_requests_answer_400_and_send_nothing(ranks, setup):
    res = ranks[0]
    assert [code for code, _ in res["bad"]] == [400] * len(worker.BAD_REQUESTS)
    _assert_close(res["bad"], setup["want"]["bad"], "bad")
    assert res["bad_sent"] == 0


def test_model_error_answers_500_and_the_server_goes_on(ranks, setup):
    """An unknown language raises inside the batch on every rank: rank 0
    answers 500 with the error, as the one-process server does, and every
    rank runs the next request."""
    res = ranks[0]
    assert res["model_error"][0] == 500
    _assert_close(res["model_error"], setup["want"]["model_error"], "model_error")
    assert res["after_error"][0] == 200


def test_followers_ran_rank0_commands_and_outlived_the_idle_period(ranks):
    """Each follower ran rank 0's commands in rank 0's order, no-ops among
    them (a quarter of the group's timeout apart while idle), and returned
    at stop()."""
    lead = ranks[0]
    assert lead["heartbeat_s"] == PG_TIMEOUT_S / 4
    assert lead["ops"].count("noop") >= int(IDLE_S / lead["heartbeat_s"]) - 1
    assert {"batch", "detect", "stream_open", "stream_feed",
            "stream_finish"} <= set(lead["ops"])
    for res in ranks[1:]:
        assert res["ops"] == lead["ops"]


def test_metrics_stay_on_rank0(ranks):
    status, metrics = ranks[0]["metrics"]
    assert status == 200 and metrics["counters"]["requests_total"] >= 7
    assert all("metrics" not in res for res in ranks[1:])


def test_main_serves_under_tensor_parallel_and_stops_on_interrupt():
    """`serve_http.main --tensor-parallel 2` on two ranks (as torchrun
    starts them): rank 0 serves, rank 1 follows; after a request, an
    interrupt on rank 0 stops the server and releases the follower, and
    main returns 0 on both ranks, leaving the caller's process group as
    it was."""
    results = worker.spawn(2, worker.server_main_run,
                           ["--model", "tiny", "--port", "0", "--tensor-parallel", "2",
                            "--sample-len", "4"])
    status, body = results[0]["answer"]
    assert status == 200 and body["segments"]
    assert [r["rc"] for r in results] == [0, 0]
    assert all(r["joined"] for r in results)
