"""Dynamic-batching synthesis serving (``transformertts_tpu/infer/serving.py``).

Concurrent requests are coalesced into one padded batch, so the decode
runs at batch sizes up to ``max_batch`` (8 by default: the CUDA
decode-step kernel takes B <= 8, and the decode splits a larger batch into
chunks of 8 rows) instead of B=1 per request.

- One worker thread owns the device and runs one batch at a time.
- Batch formation: take the oldest request, then drain the queue until
  ``max_batch`` requests or ``max_wait_ms`` elapsed, whichever is first.
- Results are delivered through ``concurrent.futures.Future`` so callers
  (HTTP handler threads, tests, user code) block only on their own item.

The HTTP front end serves mel spectrograms, or with ``format: "wav"``
Griffin-Lim waveforms (``Synthesizer.mel_to_wav``).

Spans (``utils/trace.py``): ``batcher.queued``, one per request from
``submit`` to the start of its batch's ``synthesize``, under the request's
own trace id; ``batcher.wait``, the worker blocked on an empty queue;
``batcher.fill``, from taking a batch's first request to closing the batch;
``batcher.batch`` (``rows``; ``requests``: the requests' trace ids),
``synthesize`` through delivery, whose trace id ``fill`` and the
synthesizer's spans share (``synth.g2p``, ``decode.*``, ``synth.deliver``).
``GET /healthz`` adds ``trace``: per span name over the ring, the count and
the p50 and p95 ms.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from transformertts_tpu_torch.dsp.griffin_lim import wav_bytes
from transformertts_tpu_torch.utils import trace


@dataclass
class _Request:
    text: str
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    t_ns: int = field(default_factory=time.perf_counter_ns)  # the spans' clock
    trace: int = field(default_factory=trace.new_id)


class DynamicBatcher:
    """Coalesces concurrent ``submit`` calls into batched synthesis."""

    def __init__(
        self,
        synth,
        max_batch: int = 8,
        max_wait_ms: float = 20.0,
        max_len: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.synth = synth
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_len = max_len
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()  # orders submit() vs close()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.batch_hist: dict[int, int] = {}
        self.total_latency_s = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public

    def submit(self, text: str) -> Future:
        """Queue one utterance; resolves to a (n_mels, T) float32 mel."""
        with self._submit_lock:  # no request may land behind the sentinel
            if self._closed:
                raise RuntimeError("batcher is closed")
            req = _Request(text)
            self._q.put(req)
        return req.future

    def synthesize(self, text: str, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(text).result(timeout=timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "n_requests": self.n_requests,
                "n_batches": self.n_batches,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "mean_latency_s": (
                    self.total_latency_s / self.n_requests if self.n_requests else 0.0
                ),
                "mean_batch": (
                    self.n_requests / self.n_batches if self.n_batches else 0.0
                ),
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, finish the queue, join the worker.

        Any request still unserved when the worker exits (or if the join
        times out) gets a RuntimeError on its future — nothing blocks
        forever on an abandoned result()."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the worker
        self._worker.join(timeout=timeout)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is None:
                if self._worker.is_alive():
                    # join timed out mid-decode: leave the sentinel for the
                    # wedged worker so it still exits when it comes back
                    self._q.put(None)
                    break
                continue
            if not req.future.done():
                req.future.set_exception(RuntimeError("batcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _collect(self, first: _Request) -> list[_Request]:
        """Fill the batch after its first request until full or the wait
        window closes."""
        batch = [first]
        with trace.span("batcher.fill"):
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    # shutdown sentinel: serve what we have, then exit next loop
                    self._q.put(None)
                    break
                batch.append(nxt)
        return batch

    def _run(self) -> None:
        while True:
            with trace.span("batcher.wait"):
                first = self._q.get()  # block for the first request
            if first is None:  # shutdown
                return
            with trace.scope():  # the batch's trace: its fill, batch and decode
                batch = self._collect(first)
                with trace.span("batcher.batch", rows=len(batch),
                                requests=tuple(r.trace for r in batch)):
                    self._serve(batch)

    def _serve(self, batch: list[_Request]) -> None:
        start = time.perf_counter_ns()
        for r in batch:
            trace.record("batcher.queued", r.t_ns, start, trace_id=r.trace)
        try:
            mels = self.synth.synthesize([r.text for r in batch], max_len=self.max_len)
        except Exception as e:  # deliver the failure to every waiter
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        now = time.monotonic()
        with self._stats_lock:
            self.n_batches += 1
            self.n_requests += len(batch)
            self.batch_hist[len(batch)] = self.batch_hist.get(len(batch), 0) + 1
            self.total_latency_s += sum(now - r.t_submit for r in batch)
        for r, mel in zip(batch, mels):
            if not r.future.cancelled():
                r.future.set_result(mel)


# ---------------------------------------------------------------- HTTP

def make_http_server(batcher: DynamicBatcher, host: str = "127.0.0.1", port: int = 0):
    """A threaded HTTP front-end over the batcher.

    POST /synthesize  {"text": "...", "format": "mel"|"wav"}
        -> .npy bytes (mel, shape (n_mels, T)) or RIFF wav bytes
    GET  /healthz     -> {"ok": true, ...batcher stats, "trace": per span name
                         the count and p50 / p95 ms (``utils.trace.summary``)}

    Handler threads block on their own future while the single worker
    thread batches across them — concurrency IS the batching signal.
    Returns the ``ThreadingHTTPServer`` (caller runs ``serve_forever``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live in /healthz
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **batcher.stats(), "trace": trace.summary()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict) or not isinstance(req.get("text"), str):
                    raise ValueError('body must be a JSON object with a string "text"')
                text = req["text"]
                fmt = req.get("format", "mel")
                if fmt not in ("mel", "wav"):
                    raise ValueError(f'unknown format {fmt!r}')
            except ValueError as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                mel = batcher.synthesize(text)
                if fmt == "wav":
                    synth = batcher.synth
                    payload = wav_bytes(synth.mel_to_wav(mel), synth.cfg.audio.sample_rate)
                    ctype = "audio/wav"
                else:
                    buf = io.BytesIO()
                    np.save(buf, mel)
                    payload, ctype = buf.getvalue(), "application/octet-stream"
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Mel-Frames", str(mel.shape[1]))
            self.end_headers()
            self.wfile.write(payload)

    return ThreadingHTTPServer((host, port), Handler)
