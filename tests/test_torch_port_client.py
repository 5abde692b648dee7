"""The port's stdlib client against its server, and its at-most-once POST.

- Against the port's server on the CPU (ViT-Test widened to head_dim 64,
  fp32): every call of the client, each reply equal to a direct encode of
  the same inputs (atol 1e-5).
- A scripted server that reads a kept-alive connection's second POST and
  closes it without a reply: the port's client raises, and the server saw
  that POST once; JAX's client sends it again (the reference's fault at
  JAX ``client.py:60``, ROADMAP Queue 3), so the server saw it twice.
- A server that closes a kept-alive connection between two requests: the
  client sees the closed socket before it sends and opens a new one.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import io
import socket
import threading
from http.client import RemoteDisconnected
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from spatial_clip_tpu.client import EmbeddingClient as JaxEmbeddingClient
from spatial_clip_tpu_torch.client import EmbeddingClient
from spatial_clip_tpu_torch.models.transforms import HostImageTransform, normalize_batch
from spatial_clip_tpu_torch.serve import EmbeddingService, make_handler

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
OK = b'HTTP/1.1 200 OK\r\nContent-Type: application/json\r\nContent-Length: 2\r\n\r\n{}'


@pytest.fixture(scope="module")
def served():
    service = EmbeddingService("ViT-Test", batch_size=4, precision="fp32", device="cpu", **WIDE)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield service, server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    service.close()


def test_client_against_the_port_server(served):
    from PIL import Image

    service, port = served
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    pngs = []
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(buf, "PNG")
        pngs.append(buf.getvalue())
    texts = ["a tumor tile", "lymphocytes in stroma", "EPCAM KRT8", "x", "y"]
    with torch.inference_mode():
        want_txt = service.model.encode_text(torch.from_numpy(service.tokenizer(texts)).long())
        want_tiles = service.model.encode_image(normalize_batch(torch.from_numpy(tiles)))
        transform = HostImageTransform(service.model.preprocess_cfg)
        decoded = np.stack([transform(Image.open(io.BytesIO(b))) for b in pngs])
        want_png = service.model.encode_image(normalize_batch(torch.from_numpy(decoded)))
    with EmbeddingClient("127.0.0.1", port, timeout=60) as client:
        for binary in (True, False):
            np.testing.assert_allclose(client.embed_texts(texts, binary=binary), want_txt,
                                       atol=1e-5)
            np.testing.assert_allclose(client.embed_images(pngs, binary=binary), want_png,
                                       atol=1e-5)
        np.testing.assert_allclose(client.embed_tiles(tiles), want_tiles, atol=1e-5)
        assert client.healthz()["embed_dim"] == 32
        metrics = client.metrics()
        assert metrics["requests_total"] >= 5 and metrics["errors_total"] == 0
        assert client.reset_metrics() == {"status": "metrics window reset"}
        with pytest.raises(ValueError, match="uint8 tiles"):
            client.embed_tiles(tiles[0])
        with pytest.raises(RuntimeError, match="HTTP 400"):
            client.embed_tiles(tiles[:1, :5])


class ScriptedServer:
    """An HTTP/1.1 server on a socket that answers the n-th request as its
    script says: ``ok`` (a 200 reply, the connection kept), ``close``
    (the reply, then the connection closed) or ``drop`` (the request read
    in full, the connection closed with no reply)."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = []
        self.closed = threading.Event()
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _read_request(self, f):
        line = f.readline()
        if not line:
            return None
        headers = {}
        while (h := f.readline()) not in (b"\r\n", b""):
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        f.read(int(headers.get("content-length", 0)))
        return line.decode().split()[:2]

    def _serve(self):
        while self.script:
            conn, _ = self.sock.accept()
            with conn, conn.makefile("rb") as f:
                while self.script:
                    request = self._read_request(f)
                    if request is None:
                        break
                    self.requests.append(request)
                    action = self.script.pop(0)
                    if action != "drop":
                        conn.sendall(OK)
                    if action in ("drop", "close"):
                        conn.shutdown(socket.SHUT_RDWR)
                        self.closed.set()
                        break
        self.sock.close()

    def stop(self):
        """End the script and unblock a waiting accept."""
        if self.script:
            self.script.clear()
            socket.create_connection(("127.0.0.1", self.port)).close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("client_cls,posts", [(EmbeddingClient, 1), (JaxEmbeddingClient, 2)])
def test_a_post_whose_reply_fails_is_sent_once(client_cls, posts):
    """The second POST on a kept-alive connection is read by the server,
    which closes without a reply: the port raises and the server saw it
    once; JAX's client sends it again, and the server saw it twice."""
    server = ScriptedServer(["ok", "drop", "ok"])
    client = client_cls("127.0.0.1", server.port, timeout=30)
    try:
        assert client.reset_metrics() == {}
        if posts == 1:
            with pytest.raises(RemoteDisconnected):
                client.reset_metrics()
        else:
            assert client.reset_metrics() == {}
        reset_posts = [r for r in server.requests if r == ["POST", "/metrics/reset"]]
        assert len(reset_posts) == 1 + posts
    finally:
        client.close()
        server.stop()


def test_a_connection_the_server_closed_is_reopened_before_sending():
    server = ScriptedServer(["close", "ok"])
    with EmbeddingClient("127.0.0.1", server.port, timeout=30) as client:
        assert client.healthz() == {}
        assert server.closed.wait(10)
        assert client.reset_metrics() == {}
    server.stop()
    assert server.requests == [["GET", "/healthz"], ["POST", "/metrics/reset"]]
