"""The open-loop load generator of `traffic/http_open_loop.py`, run as a
child process so that it shares no interpreter lock with the server.

It reads one JSON line on standard input: the server's port, the seed, the
requests' due offsets and lengths, and how long to wait for answers. It
makes every clip (`signals.speechy_np`), prints "ready", waits for "go",
then prints "t0 <monotonic seconds>" and posts each clip as float32 PCM
(`X-Raw-Audio: 1`) to `POST /transcribe` on its own connection at t0 plus
its offset, whatever the server is doing. At the end it prints one JSON
line: for each request when it was due, sent and answered (monotonic
seconds), the HTTP status and the answer. It imports no torch."""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import signals  # noqa: E402


def post(port: int, body: bytes, timeout: float, slot: dict) -> None:
    slot["sent"] = time.monotonic()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("POST", "/transcribe", body=body,
                         headers={"X-Raw-Audio": "1",
                                  "Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            slot["status"] = resp.status
            slot["done"] = time.monotonic()
            slot["result"] = json.loads(data) if resp.status == 200 else None
        finally:
            conn.close()
    except (OSError, http.client.HTTPException, ValueError) as e:
        slot["error"] = f"{type(e).__name__}: {e}"


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    bodies = [signals.speechy_np(n, spec["seed"], i).tobytes()
              for i, n in enumerate(spec["samples"])]
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return
    t0 = time.monotonic() + 0.2
    print(f"t0 {t0!r}", flush=True)
    slots, threads = [], []
    for off, body in zip(spec["due"], bodies):
        due = t0 + off
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        slot = {"due": due, "sent": None, "status": 0, "done": None, "result": None,
                "error": None}
        th = threading.Thread(target=post, args=(spec["port"], body, spec["timeout"], slot),
                              daemon=True)
        th.start()
        slots.append(slot)
        threads.append(th)
    deadline = t0 + spec["due"][-1] + spec["timeout"]
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    print(json.dumps({"t0": t0, "end": time.monotonic(), "requests": slots}), flush=True)


if __name__ == "__main__":
    main()
