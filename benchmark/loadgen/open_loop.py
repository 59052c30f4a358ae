"""Open-loop HTTP load: requests sent on a fixed schedule whatever the
server does, from a process of its own (so the load takes none of the
server's interpreter lock).

    python3 open_loop.py '<json settings>'

Settings: seed, sizes (the body pool's slide sizes), dim, n_types, rate
(requests/s), seconds (the window: requests due in it are sent), tail_s
(how long past the window an answer is awaited), concurrency (sending
threads), host. The process makes its body pool from the seed, prints
"ready", waits for "go <port>" on standard input, sends, and prints one
JSON line: per request [body, due_s, sent_s, done_s, http_status,
probs or error], times from the schedule's start. Every seed sends the
same multiset of bodies and of inter-arrival gaps (the quantiles of an
exponential distribution at the rate: Poisson arrivals), in its own
order.
"""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from bodies import body_arrays, encode  # noqa: E402


def schedule(seed: int, rate: float, seconds: float, n_bodies: int):
    """(due offsets [s], body index) of the requests due in the window."""
    m = max(1, int(round(rate * seconds)))
    q = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng([int(seed), 7])
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    keep = due < seconds
    passes = -(-m // n_bodies)
    order = np.concatenate([rng.permutation(n_bodies) for _ in range(passes)])
    return due[keep], order[:m][keep]


def main() -> int:
    cfg = json.loads(sys.argv[1])
    sizes = cfg["sizes"]
    pool = [encode(*body_arrays(cfg["seed"], i, n, cfg["dim"], cfg["n_types"]))
            for i, n in enumerate(sizes)]
    due, which = schedule(cfg["seed"], cfg["rate"], cfg["seconds"], len(pool))
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        print(json.dumps({"error": f"expected 'go <port>', got {line}"}), flush=True)
        return 1
    port = int(line[1])
    deadline = cfg["seconds"] + cfg["tail_s"]
    out = [None] * len(due)
    nxt = [0]
    lock = threading.Lock()
    t0 = time.perf_counter() + 0.05

    def worker():
        while True:
            with lock:
                j = nxt[0]
                nxt[0] += 1
            if j >= len(due):
                return
            wait = t0 + due[j] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent = time.perf_counter() - t0
            status, answer = 0, None
            try:
                conn = http.client.HTTPConnection(
                    cfg.get("host", "127.0.0.1"), port,
                    timeout=max(1.0, deadline - due[j]))
                conn.request("POST", "/predict", body=pool[which[j]],
                             headers={"Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                status = resp.status
                payload = json.loads(resp.read())
                conn.close()
                answer = payload.get("probs", payload.get("error"))
            except (OSError, http.client.HTTPException, ValueError) as e:
                answer = f"{type(e).__name__}: {e}"
            out[j] = [int(which[j]), float(due[j]), sent,
                      time.perf_counter() - t0, status, answer]

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(int(cfg["concurrency"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline + 30)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
