"""The port's ``make_http_server`` against ``diffus_tpu``'s: both servers, on
port 0, over the same service setup, get the same requests on every route
and must give the same status, the same JSON keys and, for frames, values
within frame-max-relative 1e-4."""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

import diffus_tpu.serve as jserve
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import BeamGeometry as JGeometry
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch import serve
from diffus_tpu_torch.types import BeamGeometry, RenderConfig
from torch_parity import frame_rel_err

VOL = brain_phantom_3d((16, 16, 16))
GEO = {"n_rays": 4, "num_samples": 8}
CFG = {"attenuation_coeff": 1e-4}
TIMEOUT = 60


def _npy_b64(arr) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return base64.b64encode(buf.getvalue()).decode()


def _frames(payload) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(payload["npy_b64"])))


class _Client:
    """One server on port 0, run on a thread, and requests to it."""

    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def call(self, method, path, payload=None, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            if body is None and payload is not None:
                body = json.dumps(payload).encode()
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"null")
        finally:
            conn.close()

    def oversized(self, path, limit):
        """A POST that announces one byte over the limit and sends none."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            conn.putrequest("POST", path)
            conn.putheader("Content-Length", str(limit + 1))
            conn.endheaders()
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def clients():
    ours = _Client(serve.make_http_server(
        serve.RendererService(VOL, BeamGeometry(**GEO), RenderConfig(**CFG), batch_tiers=(2,),
                              device="cpu"), port=0))
    theirs = _Client(jserve.make_http_server(
        jserve.RendererService(VOL, JGeometry(**GEO), JConfig(**CFG), batch_tiers=(2,)),
        port=0))
    try:
        yield ours, theirs
    finally:
        ours.close()
        theirs.close()


def _both(clients, *args, **kwargs):
    (s, got), (js, want) = (c.call(*args, **kwargs) for c in clients)
    assert s == js, (args, got, want)
    return s, got, want


def test_routes_match(clients):
    vol_b = VOL.copy()
    vol_b[6:10, 3:8, 4:12] = 7.8e6
    src = [[8.0, 1.0, 8.0], [7.5, 1.5, 8.5], [8.3, 0.7, 7.9]]
    s, got, want = _both(clients, "GET", "/healthz")
    assert s == 200 and got == want == {"ok": True}

    s, got, want = _both(clients, "POST", "/render", {"sources": src})
    assert s == 200 and set(got) == set(want) == {"shape", "dtype", "npy_b64"}
    assert got["shape"] == want["shape"] == [3, 4, 8] and got["dtype"] == want["dtype"]
    assert frame_rel_err(_frames(got), _frames(want)) < 1e-4

    s, got, want = _both(clients, "POST", "/add_scene", {"name": "b", "npy_b64": _npy_b64(vol_b),
                                                         "crop": True, "crop_margin": 2})
    assert s == 200 and got == want == {"ok": True, "name": "b", "shape": [16, 16, 16]}
    s, got, want = _both(clients, "GET", "/scenes")
    assert s == 200 and got == want
    assert got["b"]["cropped"] is True and got["default"]["staged"] == "raw"
    s, got, want = _both(clients, "POST", "/render", {"sources": src[:1], "scene": "b"})
    assert s == 200 and frame_rel_err(_frames(got), _frames(want)) < 1e-4

    s, got, want = _both(clients, "POST", "/update_volume",
                         {"npy_b64": _npy_b64(VOL * 1.1), "scene": "default"})
    assert s == 200 and got == want == {"ok": True, "shape": [16, 16, 16]}
    s, got, want = _both(clients, "POST", "/update_volume", {"npy_b64": _npy_b64(VOL[:12])})
    assert s == 400 and "allow_reshape" in got["error"] and "allow_reshape" in want["error"]
    s, got, want = _both(clients, "POST", "/update_volume",
                         {"npy_b64": _npy_b64(VOL[:12]), "allow_reshape": True})
    assert s == 200 and got == want == {"ok": True, "shape": [12, 16, 16]}
    s, got, want = _both(clients, "POST", "/render", {"sources": src})
    assert s == 200 and frame_rel_err(_frames(got), _frames(want)) < 1e-4

    s, got, want = _both(clients, "POST", "/recover", {
        "target_npy_b64": _npy_b64(_frames(got)[0]), "init_position": [8.2, 1.2, 7.8],
        "count": 2, "radius": 0.5, "rot_scale": 0.0, "phases": [[0.0, 0.1, 0.0, 4]],
        "seed": 1})
    assert s == 200 and set(got) == set(want) == {
        "position", "rotvec", "final_loss", "best_index", "positions", "rotvecs",
        "final_losses"}
    assert len(got["final_losses"]) == 2 and np.all(np.isfinite(got["final_losses"]))

    s, got, want = _both(clients, "POST", "/remove_scene", {"name": "b"})
    assert s == 200 and got == want == {"ok": True, "name": "b"}
    s, got, want = _both(clients, "GET", "/stats")
    assert s == 200 and set(got) == set(want)
    for key in ("requests", "frames", "padded_frames", "batches", "recoveries", "window_ms",
                "scenes"):
        assert got[key] == want[key], key
    assert set(got["latency_dispatched_ms"]) == set(want["latency_dispatched_ms"])


@pytest.mark.parametrize("method, path, payload, body", [
    ("POST", "/render", None, b"{}"),                                        # no sources
    ("POST", "/render", {"sources": [[8.0, 1.0, 8.0]], "scene": "nope"}, None),
    ("POST", "/render", None, b"not json"),
    ("POST", "/remove_scene", {"name": "default"}, None),
    ("POST", "/recover", {"target_npy_b64": _npy_b64(np.zeros((3, 3))),
                          "init_position": [8.0, 1.0, 8.0]}, None),
    ("POST", "/nope", {}, None),
    ("GET", "/nope", None, None),
], ids=["missing-key", "unknown-scene", "bad-json", "remove-default", "bad-target",
        "post-404", "get-404"])
def test_errors_match(clients, method, path, payload, body):
    s, got, want = _both(clients, method, path, payload, body)
    assert s == (404 if path == "/nope" else 400)
    assert set(got) == set(want) == {"error"}
    assert got["error"].split(":")[0] == want["error"].split(":")[0]
    s, got, want = _both(clients, "GET", "/healthz")    # the servers are still up
    assert s == 200


def test_oversized_body_gets_413_before_it_is_read(clients):
    for c in clients:
        status, payload = c.oversized("/add_scene", 1 << 30)
        assert status == 413 and "limit" in payload["error"]
        assert c.call("GET", "/healthz")[0] == 200


class _HalfOpenWriter(io.BytesIO):
    """A response stream whose client hangs up after the status and headers."""

    def __init__(self):
        super().__init__()
        self.writes = 0

    def write(self, data):
        self.writes += 1
        if self.writes > 1:
            raise BrokenPipeError("client hung up")
        return super().write(data)


@pytest.mark.parametrize("make", [serve.make_http_server, jserve.make_http_server],
                         ids=["port", "jax"])
def test_no_second_status_line_after_a_partial_200(make):
    """A failure while a 200 is being written closes the connection instead
    of writing a 400 onto the same stream."""
    svc = type("Healthy", (), {"render": lambda self, s, scene="default": torch.zeros(1, 2)})()
    server = make(svc, port=0)
    try:
        handler = object.__new__(server.RequestHandlerClass)
        body = json.dumps({"sources": [[1.0, 1.0, 1.0]]}).encode()
        handler.rfile, handler.wfile = io.BytesIO(body), _HalfOpenWriter()
        handler.headers = {"Content-Length": str(len(body))}
        handler.path, handler.command = "/render", "POST"
        handler.request_version, handler.requestline = "HTTP/1.1", "POST /render HTTP/1.1"
        handler.client_address = ("127.0.0.1", 0)
        handler.do_POST()
        written = handler.wfile.getvalue()
        assert written.count(b"HTTP/1.") == 1 and written.split(b" ")[1] == b"200"
        assert handler.close_connection
    finally:
        server.server_close()
