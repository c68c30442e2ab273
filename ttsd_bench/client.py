"""The open-loop streaming client, run in a child process of its own.

Standard library only, so the yardstick does not move when the port
changes. A scheduler thread starts each request's thread at the moment it
is due (Poisson arrivals fixed by the traffic file and the seed), whether
or not earlier requests have finished. Each request POSTs ``"stream":
true`` to /v1/audio/speech and reads the raw 16-bit PCM as it comes.

Bytes that arrive with no gap above ``CHUNK_GAP_S`` between reads form one
chunk (the server writes and flushes one vocoded chunk at a time, seconds
apart). Times are ``time.monotonic()``, which the parent shares.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import List

CHUNK_GAP_S = 0.02


def _one(port: int, req: dict, t0: float, timeout: float, out: dict) -> None:
    due = t0 + req["due"]
    out["sent"] = time.monotonic()
    body = {"input": req["script"], "stream": True,
            "max_tokens": req["max_tokens"], "seed": req["seed"]}
    if req.get("voice"):
        body["voice"] = req["voice"]
    chunks: List[list] = []       # [first byte time, last byte time, bytes]
    pcm = bytearray()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("POST", "/v1/audio/speech", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        if resp.status != 200:
            out["error"] = resp.read().decode(errors="replace")[:300]
        else:
            while True:
                data = resp.read1(1 << 16)
                now = time.monotonic()
                if not data:
                    break
                if chunks and now - chunks[-1][1] <= CHUNK_GAP_S:
                    chunks[-1][1] = now
                    chunks[-1][2] += len(data)
                else:
                    chunks.append([now, now, len(data)])
                pcm += data
            out["done"] = True
        conn.close()
    except (OSError, http.client.HTTPException) as e:
        out["error"] = f"{type(e).__name__}: {e}"
    out["due"] = due
    out["chunks"] = chunks
    out["pcm"] = bytes(pcm)


def run(port: int, reqs: List[dict], t0: float, timeout: float) -> List[dict]:
    """Send every request at t0 + its due offset; wait for all of them."""
    results = [{"status": None, "done": False} for _ in reqs]
    threads = []
    for req, out in zip(reqs, results):
        delay = t0 + req["due"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=_one, args=(port, req, t0, timeout, out),
                              daemon=True)
        th.start()
        threads.append(th)
    end = t0 + (reqs[-1]["due"] if reqs else 0.0) + timeout
    for th in threads:
        th.join(max(0.0, end - time.monotonic()))
    return results


def main(conn, port: int, reqs: List[dict], timeout: float) -> None:
    """Child-process entry: say it is ready, wait for the parent's start
    time, run, send the results back over ``conn``."""
    conn.send("ready")
    t0 = conn.recv()
    conn.send(run(port, reqs, t0, timeout))
    conn.close()
