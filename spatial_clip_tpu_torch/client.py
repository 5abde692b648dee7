"""Stdlib client of the embedding server (counterpart of
``spatial_clip_tpu.client``; ``serve.py`` is the server).

Only ``http.client``, over one kept-alive connection. The defaults are the
server's cheapest wire choices: ``b64_f32`` binary replies, and the raw
pixel body for tiles at the model's input size.

    from spatial_clip_tpu_torch.client import EmbeddingClient

    c = EmbeddingClient("localhost", 8764)
    emb = c.embed_texts(["a cat", "a dog"])          # (2, D) float32
    emb = c.embed_images([png_bytes, jpeg_bytes])    # encoded images
    emb = c.embed_tiles(batch_u8)                    # (N, H, W, 3) uint8 raw

A request is sent at most once. Before a request goes out on a connection
that has carried one, the client checks that the server has not closed it
(a readable idle socket is one the server closed), and opens a new one if
it has; a send that fails on a reused connection is retried once on a new
one. Once the request has been sent, an error while the reply is read is
raised, never retried: the server may have run the request
(``/metrics/reset`` included).
"""
from __future__ import annotations

import base64
import json
import select
from http.client import HTTPConnection
from typing import Optional, Sequence

import numpy as np


class EmbeddingClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8764, timeout: float = 600.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._conn: Optional[HTTPConnection] = None

    def _connection(self) -> HTTPConnection:
        if self._conn is None:
            self._conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _closed_by_server(self) -> bool:
        """Whether the kept-alive connection's socket is readable while no
        reply is due: the server closed it (or broke the protocol)."""
        sock = self._conn.sock if self._conn is not None else None
        if sock is None:
            return False
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable)

    def _request(self, method: str, path: str, body=None,
                 headers: Optional[dict] = None) -> dict:
        if self._closed_by_server():
            self.close()
        reused = self._conn is not None and self._conn.sock is not None
        conn = self._connection()
        try:
            conn.request(method, path, body, headers or {})
        except TimeoutError:
            raise  # a slow server is not a closed connection
        except (ConnectionError, OSError):
            if not reused:
                raise
            self.close()  # the server closed it as the request went out: it was not run
            conn = self._connection()
            conn.request(method, path, body, headers or {})
        resp = conn.getresponse()  # sent: from here on an error is raised, not retried
        data = json.loads(resp.read())
        if resp.status != 200:
            raise RuntimeError(f"{path} -> HTTP {resp.status}: {data.get('error', data)}")
        return data

    def _post(self, path: str, body, headers: Optional[dict] = None) -> dict:
        return self._request("POST", path, body, headers)

    def _get(self, path: str) -> dict:
        return self._request("GET", path)

    @staticmethod
    def _decode_reply(data: dict) -> np.ndarray:
        if "embeddings_b64" in data:  # binary reply (b64_f32)
            return np.frombuffer(base64.b64decode(data["embeddings_b64"]),
                                 data.get("dtype", "<f4")).reshape(data["shape"]).copy()
        return np.asarray(data["embeddings"], np.float32)

    def embed_texts(self, texts: Sequence[str], binary: bool = True) -> np.ndarray:
        """(N, D) float32 unit-norm text embeddings."""
        req = {"texts": list(texts)}
        if binary:
            req["encoding"] = "b64_f32"
        return self._decode_reply(self._post("/embed_text", json.dumps(req)))

    def embed_images(self, images: Sequence[bytes], binary: bool = True) -> np.ndarray:
        """(N, D) embeddings of ENCODED images (png / jpeg bytes)."""
        req = {"images_b64": [base64.b64encode(b).decode() for b in images]}
        if binary:
            req["encoding"] = "b64_f32"
        return self._decode_reply(self._post("/embed_image", json.dumps(req)))

    def embed_tiles(self, tiles: np.ndarray) -> np.ndarray:
        """(N, D) embeddings of DECODED (N, H, W, 3) uint8 tiles at the
        model's input size, sent as raw bytes."""
        tiles = np.ascontiguousarray(tiles, np.uint8)
        if tiles.ndim != 4 or tiles.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) uint8 tiles, got {tiles.shape}")
        return self._decode_reply(self._post(
            "/embed_image_raw", tiles.tobytes(), {"Content-Type": "application/octet-stream"}))

    def healthz(self) -> dict:
        return self._get("/healthz")

    def metrics(self) -> dict:
        return self._get("/metrics")

    def reset_metrics(self) -> dict:
        return self._post("/metrics/reset", "{}")
