"""Batched embedding server on one GPU (counterpart of ``spatial_clip_tpu.serve``).

One process serves one card. Requests are cut into chunks of at most
``batch_size`` items and each chunk runs the encoder eagerly on its real rows
(no padding: PyTorch needs no fixed shape). The HTTP front is the stdlib
``ThreadingHTTPServer``: no TLS, no auth; put a real ingress in front of it
for anything public.

    python -m spatial_clip_tpu_torch.serve --model ViT-B-32 --port 8764 [--mlp-impl pallas]
    curl -X POST localhost:8764/embed_text -d '{"texts": ["a cat"]}'

Endpoints:
- ``POST /embed_text``  {"texts": [str, ...]} -> {"embeddings": [[...], ...]}
- ``POST /embed_image`` {"images_b64": [base64 image, ...]} -> embeddings
  (decoding needs Pillow)
- ``POST /embed_image_raw`` body = n tightly packed (size, size, 3) uint8
  tiles; replies in the b64_f32 encoding unless ``?encoding=json``
- ``GET  /healthz``     liveness + model metadata
- ``GET  /metrics``     request counts, QPS, batch fill, p50/p99 latency
- ``POST /metrics/reset`` clear the rolling latency/QPS window (totals kept)

Limits: a body over ``--max-body-bytes`` or more than ``--max-items`` items is
413; when ``--max-inflight`` requests are already admitted, new work is 503
(retry with backoff); a body sent with ``Transfer-Encoding`` (chunked) is 411,
because every request must carry a Content-Length.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import torch

from spatial_clip_tpu_torch.models.factory import create_model, get_tokenizer
from spatial_clip_tpu_torch.models.transforms import HostImageTransform, normalize_batch

log = logging.getLogger(__name__)


class ServerMetrics:
    """Thread-safe rolling request metrics for the /metrics endpoint."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)  # (t_done, latency_s)
        self._done_ts = deque(maxlen=65536)  # completions, for qps_1m
        self._fill = deque(maxlen=window)  # real rows / batch_size per encode
        self.requests_total = 0
        self.items_total = 0
        self.errors_total = 0
        self.rejected_total = 0
        self._t0 = time.monotonic()
        self._window_t0 = self._t0

    def observe(self, latency_s: float, n_items: int):
        with self._lock:
            self.requests_total += 1
            self.items_total += n_items
            now = time.monotonic()
            self._lat.append((now, latency_s))
            self._done_ts.append(now)

    def observe_fill(self, fill: float):
        with self._lock:
            self._fill.append(fill)

    def error(self):
        with self._lock:
            self.errors_total += 1

    def rejected(self):
        with self._lock:
            self.rejected_total += 1

    def reset_window(self):
        """Clear the rolling latency/fill/QPS windows; totals are kept."""
        with self._lock:
            self._lat.clear()
            self._done_ts.clear()
            self._fill.clear()
            self._window_t0 = time.monotonic()

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            lats = sorted(l for _, l in self._lat)
            recent = [t for t in self._done_ts if now - t <= 60.0]
            qps = len(recent) / min(60.0, max(now - self._window_t0, 1e-9))

            def pct(p):
                if not lats:
                    return None
                return round(1000 * lats[min(len(lats) - 1, int(p * len(lats)))], 2)

            return {
                "requests_total": self.requests_total,
                "items_total": self.items_total,
                "errors_total": self.errors_total,
                "rejected_total": self.rejected_total,
                "qps_1m": round(qps, 3),
                "latency_ms_p50": pct(0.50),
                "latency_ms_p99": pct(0.99),
                "batch_fill_mean": (
                    round(float(np.mean(self._fill)), 4) if self._fill else None),
                "uptime_s": round(now - self._t0, 1),
            }


class EmbeddingService:
    """The two encoders on one device, run in chunks of ``batch_size``."""

    def __init__(self, model_name: str = "ViT-B-32", batch_size: int = 64,
                 precision: str = "bf16", device: str = "cuda", max_inflight: int = 32,
                 **model_kw):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.model = create_model(model_name, precision=precision, seed=0,
                                  device=self.device, **model_kw)
        self.tokenizer = get_tokenizer(model_name)
        self.image_size = int(self.model.cfg.vision_cfg.size)
        # one encoder call at a time: the card is the serialized resource;
        # the semaphore bounds the queue behind it (backpressure)
        self._lock = threading.Lock()
        self._inflight = threading.BoundedSemaphore(max_inflight)
        n_cores = os.cpu_count() or 1
        self._decode_pool = (ThreadPoolExecutor(max_workers=min(n_cores, 16),
                                                thread_name_prefix="img-decode")
                             if n_cores > 1 else None)
        self.metrics = ServerMetrics()

    @torch.inference_mode()
    def _enc_img(self, tiles_u8: np.ndarray) -> torch.Tensor:
        pp = self.model.preprocess_cfg
        x = torch.from_numpy(tiles_u8).to(self.device)
        return self.model.encode_image(
            normalize_batch(x, mean=pp.mean, std=pp.std, dtype=self.model.dtype))

    @torch.inference_mode()
    def _enc_txt(self, ids: np.ndarray) -> torch.Tensor:
        return self.model.encode_text(torch.from_numpy(ids).to(self.device))

    def _batched(self, encode, arr: np.ndarray) -> np.ndarray:
        """Encode ``arr`` in chunks of at most ``batch_size`` rows."""
        out = []
        with self._lock:
            for lo in range(0, len(arr), self.batch_size):
                chunk = arr[lo: lo + self.batch_size]
                out.append(encode(chunk).float().cpu().numpy())
                self.metrics.observe_fill(len(chunk) / self.batch_size)
        return np.concatenate(out, axis=0)

    def acquire_slot(self) -> bool:
        """Non-blocking admission; False = saturated (caller replies 503)."""
        return self._inflight.acquire(blocking=False)

    def release_slot(self):
        self._inflight.release()

    def warmup(self):
        """Build the kernels and warm the libraries before serving traffic."""
        self.embed_texts(["warmup"])
        self._batched(self._enc_img,
                      np.zeros((1, self.image_size, self.image_size, 3), np.uint8))
        log.info("encoders warmed (text + image)")

    def embed_texts(self, texts) -> np.ndarray:
        ids = np.asarray(self.tokenizer(list(texts)), dtype=np.int64)
        return self._batched(self._enc_txt, ids)

    def embed_images_b64(self, images_b64) -> np.ndarray:
        from PIL import Image

        tiles = np.empty((len(images_b64), self.image_size, self.image_size, 3), np.uint8)
        transform = HostImageTransform(self.model.preprocess_cfg)

        def decode(item):
            i, b = item
            tiles[i] = transform(Image.open(io.BytesIO(base64.b64decode(b))))

        items = list(enumerate(images_b64))
        # Pillow's decode releases the GIL, so a thread pool scales with cores
        if len(items) > 4 and self._decode_pool is not None:
            list(self._decode_pool.map(decode, items))
        else:
            for item in items:
                decode(item)
        return self._batched(self._enc_img, tiles)

    def embed_images_raw(self, body: bytes) -> np.ndarray:
        """``body`` is n tightly packed (size, size, 3) uint8 tiles."""
        size = self.image_size
        tile_bytes = size * size * 3
        if len(body) == 0 or len(body) % tile_bytes != 0:
            raise ValueError(
                f"raw image body must be n*{tile_bytes} bytes "
                f"(n tiles of {size}x{size}x3 uint8); got {len(body)}")
        # bytearray: a writable copy, which torch.from_numpy wants
        tiles = np.frombuffer(bytearray(body), np.uint8).reshape(-1, size, size, 3)
        return self._batched(self._enc_img, tiles)

    def close(self):
        if self._decode_pool is not None:
            self._decode_pool.shutdown()

    def metadata(self) -> dict:
        return {
            "model": self.model.model_name,
            "embed_dim": int(self.model.cfg.embed_dim),
            "image_size": self.image_size,
            "batch_size": self.batch_size,
            "device": str(self.device),
        }


def _b64_f32(emb: np.ndarray) -> dict:
    """Binary reply: decode with np.frombuffer(base64.b64decode(
    r["embeddings_b64"]), "<f4").reshape(r["shape"])."""
    return {
        "embeddings_b64": base64.b64encode(
            np.ascontiguousarray(emb, dtype="<f4").tobytes()).decode(),
        "shape": list(emb.shape),
        "dtype": "<f4",
    }


def make_handler(service: EmbeddingService, max_body_bytes: int = 32 * 2 ** 20,
                 max_items: int = 1024):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every reply carries Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _reply(self, code: int, payload: dict, close: bool = False):
            """``close=True`` for any reply sent before the request body was
            read in full: under keep-alive the unread bytes would otherwise
            be parsed as the next request."""
            body = json.dumps(payload).encode()
            self.reply_started = True
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _fail(self, e: Exception):
            """Error reply for a failed request, unless a reply already began:
            a second reply would land inside the first one's body, so the
            connection is closed instead."""
            service.metrics.error()
            if self.reply_started:
                log.warning("request failed after its reply began: %r", e)
                self.close_connection = True
                return
            try:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except (BrokenPipeError, ConnectionResetError):
                log.debug("client disconnected before error reply")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", **service.metadata()})
            elif self.path == "/metrics":
                self._reply(200, service.metrics.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _admit(self, n_items: int) -> bool:
            """413 over the item limit, 503 when saturated; else take a slot."""
            if n_items > max_items:
                service.metrics.rejected()
                self._reply(413, {"error": f"{n_items} items exceeds per-request "
                                           f"limit {max_items}; split the request"})
                return False
            if not service.acquire_slot():
                service.metrics.rejected()
                self._reply(503, {"error": "server saturated; retry with backoff"})
                return False
            return True

        def _serve(self, t0: float, n_items: int, run, encoding: str):
            """Run an admitted request, reply, record it, free its slot."""
            try:
                emb = run()
                self._reply(200, _b64_f32(emb) if encoding == "b64_f32"
                            else {"embeddings": emb.tolist()})
                # observed after the reply is written: latency includes
                # serialization and the socket write
                service.metrics.observe(time.monotonic() - t0, n_items)
            except (BrokenPipeError, ConnectionResetError):
                log.debug("client disconnected mid-response")
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 — error surface per request
                self._fail(e)
            finally:
                service.release_slot()

        def do_POST(self):
            t0 = time.monotonic()
            self.reply_started = False
            if "Transfer-Encoding" in self.headers:
                # the body's length is unknown without decoding the chunks;
                # refuse it and close, so its bytes are never read as a request
                service.metrics.error()
                return self._reply(411, {"error": "Content-Length required; "
                                                  "Transfer-Encoding is not accepted"},
                                   close=True)
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0:
                return self._reply(400, {"error": "bad Content-Length"}, close=True)
            if n > max_body_bytes:
                service.metrics.rejected()
                return self._reply(413, {
                    "error": f"request body {n} bytes exceeds limit {max_body_bytes}"},
                    close=True)
            path, _, query = self.path.partition("?")
            body = self.rfile.read(n)
            if path == "/embed_image_raw":
                size = service.image_size
                n_tiles, rem = divmod(len(body), size * size * 3)
                if n_tiles == 0 or rem != 0:
                    service.metrics.error()
                    return self._reply(400, {
                        "error": f"raw body must be n*{size * size * 3} bytes "
                                 f"({size}x{size}x3 uint8 tiles); got {len(body)}"})
                if self._admit(n_tiles):
                    json_reply = parse_qs(query).get("encoding", [""])[0] == "json"
                    self._serve(t0, n_tiles, lambda: service.embed_images_raw(body),
                                "json" if json_reply else "b64_f32")
                return
            try:
                req = json.loads(body or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                service.metrics.error()
                return self._reply(400, {"error": f"invalid JSON: {e}"})
            if not isinstance(req, dict):
                service.metrics.error()
                return self._reply(400, {"error": "request body must be a JSON object"})
            if path == "/metrics/reset":
                service.metrics.reset_window()
                return self._reply(200, {"status": "metrics window reset"})
            if path == "/embed_text":
                items, run = req.get("texts"), service.embed_texts
            elif path == "/embed_image":
                items, run = req.get("images_b64"), service.embed_images_b64
            else:
                return self._reply(404, {"error": f"unknown path {self.path}"})
            if not isinstance(items, list) or not items:
                service.metrics.error()
                return self._reply(400, {
                    "error": "expected a non-empty list under 'texts' / 'images_b64'"})
            if self._admit(len(items)):
                self._serve(t0, len(items), lambda: run(items), req.get("encoding"))

    return Handler


def serve(service: EmbeddingService, host: str = "127.0.0.1", port: int = 8764,
          max_body_bytes: int = 32 * 2 ** 20, max_items: int = 1024):
    server = ThreadingHTTPServer((host, port), make_handler(service, max_body_bytes, max_items))
    log.info("serving %s on %s:%d", service.metadata(), host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mlp-impl", default="dense",
                    help="dense | pallas (the fused MLP kernel); int8 is not ported")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8764)
    ap.add_argument("--max-body-bytes", type=int, default=32 * 2 ** 20)
    ap.add_argument("--max-items", type=int, default=1024)
    ap.add_argument("--max-inflight", type=int, default=32)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the boot-time kernel build and encoder warmup")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    service = EmbeddingService(args.model, batch_size=args.batch_size,
                               precision=args.precision, device=args.device,
                               max_inflight=args.max_inflight, mlp_impl=args.mlp_impl)
    if not args.no_warmup:
        service.warmup()
        service.metrics.reset_window()
    serve(service, args.host, args.port,
          max_body_bytes=args.max_body_bytes, max_items=args.max_items)


if __name__ == "__main__":
    main()
