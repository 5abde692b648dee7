"""The port's embedding server on the CPU: encoders, HTTP surface, limits.

The service runs ViT-Test widened to head_dim 64 (the attention kernel's
geometry) on the CPU, where attention takes the kernel's plain version. Its
replies must equal direct ``encode_*`` calls on the same weights.
"""
from __future__ import annotations

import base64
import io
import json
import socket
import threading
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from spatial_clip_tpu_torch.models.transforms import normalize_batch
from spatial_clip_tpu_torch.serve import EmbeddingService, make_handler

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))


@pytest.fixture(scope="module")
def service():
    svc = EmbeddingService("ViT-Test", batch_size=4, precision="fp32", device="cpu", **WIDE)
    yield svc
    svc.close()


@pytest.fixture
def server(service, request):
    limits = getattr(request, "param", {})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service, **limits))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _direct_text(service, texts):
    ids = torch.from_numpy(service.tokenizer(texts)).long()
    with torch.inference_mode():
        return service.model.encode_text(ids).numpy()


def _direct_image(service, tiles):
    x = normalize_batch(torch.from_numpy(tiles))
    with torch.inference_mode():
        return service.model.encode_image(x).numpy()


def _tiles(seed, n, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _request(port, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _decode_b64(reply):
    return np.frombuffer(base64.b64decode(reply["embeddings_b64"]),
                         reply["dtype"]).reshape(reply["shape"])


def _raw_exchange(port, request: bytes) -> bytes:
    """Send raw bytes, read until the server closes the connection."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(request)
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                return b"".join(chunks)
            chunks.append(data)


def test_text_batches_match_direct_encode(service):
    """7 texts cross one chunk boundary at batch_size 4; each chunk runs its
    real rows, and fill is recorded as real / batch_size."""
    texts = [f"gene sentence {i}" for i in range(7)]
    service.metrics.reset_window()
    emb = service.embed_texts(texts)
    assert emb.shape == (7, 32)
    np.testing.assert_allclose(emb, _direct_text(service, texts), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)
    assert service.metrics.snapshot()["batch_fill_mean"] == pytest.approx((1 + 3 / 4) / 2)


def test_raw_images_match_direct_encode(service):
    tiles = _tiles(0, 5)
    emb = service.embed_images_raw(tiles.tobytes())
    assert emb.shape == (5, 32)
    np.testing.assert_allclose(emb, _direct_image(service, tiles), atol=1e-5)
    with pytest.raises(ValueError, match="raw image body"):
        service.embed_images_raw(b"\x00" * (32 * 32 * 3 - 1))


def test_b64_images_match_raw_path(service):
    from PIL import Image

    exact, big = _tiles(1, 1)[0], _tiles(2, 1, size=64)[0]

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    emb = service.embed_images_b64([png(exact), png(big)])
    # the 64x64 tile is resized (shortest side, bicubic) and center-cropped
    small = np.asarray(Image.fromarray(big).resize((32, 32), Image.BICUBIC))
    want = service.embed_images_raw(np.stack([exact, small]).tobytes())
    np.testing.assert_allclose(emb, want, atol=1e-5)


def test_healthz_and_metrics(service, server):
    status, body = _request(server, "GET", "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["embed_dim"] == 32 and health["batch_size"] == 4
    assert health["device"] == "cpu"
    _request(server, "POST", "/embed_text", json.dumps({"texts": ["metrics"]}))
    status, body = _request(server, "GET", "/metrics")
    m = json.loads(body)
    assert status == 200 and m["requests_total"] >= 1 and m["latency_ms_p50"] is not None
    status, _ = _request(server, "POST", "/metrics/reset", "{}")
    assert status == 200
    after = json.loads(_request(server, "GET", "/metrics")[1])
    assert after["latency_ms_p50"] is None
    assert after["requests_total"] == m["requests_total"]
    assert _request(server, "GET", "/nope")[0] == 404


@pytest.mark.parametrize("encoding", ["json", "b64_f32"])
def test_embed_text_endpoint(service, server, encoding):
    texts = ["a cell", "a tile", "stroma", "tumor", "immune infiltrate"]
    status, body = _request(server, "POST", "/embed_text",
                            json.dumps({"texts": texts, "encoding": encoding}))
    assert status == 200
    reply = json.loads(body)
    emb = np.asarray(reply["embeddings"]) if encoding == "json" else _decode_b64(reply)
    assert emb.shape == (5, 32)
    np.testing.assert_allclose(emb, _direct_text(service, texts), atol=1e-5)


@pytest.mark.parametrize("query", ["", "?encoding=json", "?client_encoding=json"])
def test_embed_image_raw_endpoint(service, server, query):
    tiles = _tiles(3, 6)
    status, body = _request(server, "POST", "/embed_image_raw" + query, tiles.tobytes(),
                            {"Content-Type": "application/octet-stream"})
    assert status == 200
    reply = json.loads(body)
    if query == "?encoding=json":
        emb = np.asarray(reply["embeddings"])
    else:  # binary is the default; only encoding=json opts into floats
        emb = _decode_b64(reply)
    np.testing.assert_allclose(emb, _direct_image(service, tiles), atol=1e-5)


@pytest.mark.parametrize("path,body", [
    ("/embed_text", "{nope"),
    ("/embed_text", json.dumps([1, 2])),
    ("/embed_text", json.dumps({"texts": []})),
    ("/embed_text", json.dumps({"bad": 1})),
    ("/embed_image_raw", b"abc"),
])
def test_bad_requests_are_400(server, path, body):
    status, reply = _request(server, "POST", path, body)
    assert status == 400 and b"error" in reply


@pytest.mark.parametrize("server", [dict(max_body_bytes=256, max_items=3)], indirect=True)
def test_size_limits_are_413(server):
    assert _request(server, "POST", "/embed_text", json.dumps({"texts": ["x" * 500]}))[0] == 413
    body = json.dumps({"texts": ["a", "b", "c", "d"]})
    assert _request(server, "POST", "/embed_text", body)[0] == 413
    assert _request(server, "POST", "/embed_text", json.dumps({"texts": ["a", "b"]}))[0] == 200


def test_saturation_is_503(service, server):
    taken = 0
    while service.acquire_slot():
        taken += 1
    try:
        status, body = _request(server, "POST", "/embed_text", json.dumps({"texts": ["x"]}))
        assert status == 503 and b"retry" in body
    finally:
        for _ in range(taken):
            service.release_slot()
    assert _request(server, "POST", "/embed_text", json.dumps({"texts": ["x"]}))[0] == 200


def test_keep_alive_serves_consecutive_requests(service, server):
    conn = HTTPConnection("127.0.0.1", server, timeout=60)
    try:
        for texts in (["one"], ["two", "three"]):
            conn.request("POST", "/embed_text", json.dumps({"texts": texts}))
            resp = conn.getresponse()
            assert resp.status == 200
            assert len(json.loads(resp.read())["embeddings"]) == len(texts)
    finally:
        conn.close()


def test_chunked_body_is_411_and_closes(server):
    """A chunked body has no Content-Length: it is refused and the connection
    closed, so its chunks are never parsed as a next request."""
    reply = _raw_exchange(server, (
        b"POST /embed_text HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"11\r\n{\"texts\": [\"a\"]}\r\n0\r\n\r\n"
        b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n"))
    assert reply.startswith(b"HTTP/1.1 411")
    assert reply.count(b"HTTP/1.1 ") == 1


def test_failure_after_reply_began_sends_no_second_reply(service):
    """If writing the 200 reply fails partway (other than a reset), the
    handler must close the connection, not append an error reply to it."""
    handler = make_handler(service)

    class Failing(handler):
        def end_headers(self):
            super().end_headers()
            if self.path == "/embed_text":
                raise TimeoutError("socket write timed out")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Failing)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        errors = service.metrics.errors_total
        body = json.dumps({"texts": ["a"]}).encode()
        reply = _raw_exchange(srv.server_address[1], (
            b"POST /embed_text HTTP/1.1\r\nHost: x\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body))
        assert reply.startswith(b"HTTP/1.1 200")
        assert reply.count(b"HTTP/1.1 ") == 1
        assert service.metrics.errors_total == errors + 1
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
