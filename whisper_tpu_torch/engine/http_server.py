"""HTTP serving front-end: the network-facing half of the serving layer.

Counterpart of ``whisper_tpu/engine/http_server.py``: a stdlib
``ThreadingHTTPServer`` (a thread per connection, each blocking on a
transcriber future) over ``ContinuousTranscriber`` (the slot pool),
``AsyncTranscriber`` (micro-batching) or the engine itself under a lock.

Endpoints:
  POST /transcribe   body = WAV container bytes, or raw little-endian
                     float32 PCM with a Content-Type containing "pcm"
                     (e.g. application/octet-stream+pcm)
                     → 200 JSON {text, language, length, avg_logprob,
                        compression_ratio, temperature, segments?}
  GET  /healthz      → 200 {"status": "ok", "mode": ...}
  GET  /metrics      → 200 the engine's throughput counters (audio-s/s,
                     tokens/s, RTF), request and error counts, and the slot
                     pool's occupancy in continuous mode
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from whisper_tpu_torch.audio.wav import read_wav_bytes
from whisper_tpu_torch.engine.serving import AsyncTranscriber, ContinuousTranscriber


def _parse_audio(body: bytes, content_type: str) -> np.ndarray:
    """Request bytes → float32 sample vector (16 kHz mono)."""
    if "pcm" in content_type:
        return np.frombuffer(body, dtype="<f4").astype(np.float32)
    return read_wav_bytes(body)


class TranscribeServer:
    """Owns an engine-backed transcriber and a ThreadingHTTPServer.

    ``mode``: "continuous" (the slot pool), "async" (micro-batching queue),
    or "sync" (a direct engine call under a lock, for debugging)."""

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        mode: str = "continuous",
        n_slots: int = 8,
        max_batch: int = 8,
    ):
        self.engine = engine
        self.mode = mode
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        if mode == "continuous":
            self._transcriber = ContinuousTranscriber(engine, n_slots=n_slots)
            self._transcriber.warmup()
        elif mode == "async":
            self._transcriber = AsyncTranscriber(engine, max_batch=max_batch)
            self._transcriber.warmup()
        elif mode == "sync":
            self._transcriber = None
        else:
            raise ValueError(f"unknown serve mode: {mode!r}")

        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet default request logging; errors still surface as JSON
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def _reply(self, code: int, payload: dict):
                data = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok", "mode": server.mode})
                elif self.path == "/metrics":
                    self._reply(200, server.metrics())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path != "/transcribe":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    self._reply(400, {"error": "empty body"})
                    return
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                try:
                    samples = _parse_audio(body, ctype)
                except Exception as exc:  # bad container → client error
                    server._count(error=True)
                    self._reply(400, {"error": f"bad audio: {exc}"})
                    return
                try:
                    result = server.transcribe(samples)
                except Exception as exc:  # engine-side failure is isolated
                    server._count(error=True)  # to this request
                    self._reply(500, {"error": str(exc)})
                    return
                server._count()
                payload = {
                    "text": result.clean_text(),
                    "language": result.language,
                    "length": result.length,
                    "avg_logprob": result.avg_logprob,
                    "compression_ratio": result.compression_ratio,
                    "temperature": result.temperature,
                }
                if result.segments is not None:
                    payload["segments"] = [
                        {"start": s.start, "end": s.end, "text": s.text}
                        for s in result.segments
                    ]
                self._reply(200, payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _count(self, error: bool = False):
        with self._lock:
            self._requests += 1
            if error:
                self._errors += 1

    def transcribe(self, samples: np.ndarray):
        if self._transcriber is None:
            with self._lock:
                return self.engine.transcribe(samples)
        return self._transcriber.submit(samples).result()

    def metrics(self) -> dict:
        out = {
            "requests": self._requests,
            "errors": self._errors,
            "throughput": self.engine.throughput.as_dict(),
        }
        if self.mode == "continuous" and self._transcriber is not None:
            out["occupancy"] = self._transcriber.occupancy
            out["dispatch_efficiency"] = self._transcriber.dispatch_efficiency
        return out

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> "TranscribeServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="whisper-tpu-torch-http", daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self):
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._transcriber is not None:
            self._transcriber.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
