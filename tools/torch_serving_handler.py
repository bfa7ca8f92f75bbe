#!/usr/bin/env python
"""Serving handler and HTTP server of the PyTorch port (the counterpart of
tools/deployment/serving_handler.py, itself shaped like the reference's
torchserve handler).

The handler loads a servable directory written by tools/torch_pnp2servable.py
(the frozen config and the generator's weights) onto one device and serves
the torchserve-shaped endpoint:

    POST /predictions/<model-name>    body: PNG/JPEG image bytes
    -> 200, body: the enhanced frame as PNG bytes
    GET /ping                         -> 200 {"status": "Healthy"}

One image per request, enhanced as a clip of one frame with neutral codec
priors (``pnp_vcve_torch.apis.restoration_inference``); clips go through
tools/torch_test.py or ``pnp_vcve_torch.serving`` instead.
``ThreadingHTTPServer`` answers each request on a thread of its own, and
PyTorch's grad mode is per thread, so each request holds
``torch.inference_mode()``; a lock keeps one forward on the device at a
time.

Usage:
    python tools/torch_serving_handler.py SERVABLE_DIR [--port 8080] [--device cuda|cpu]

``--device cuda`` (the default) runs the CUDA kernels and fails when there
is no GPU; it never falls back.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class PnPServingHandler:
    """initialize / preprocess / inference / postprocess, as the reference's
    torchserve handler."""

    def __init__(self):
        self.initialized = False
        self._lock = threading.Lock()

    def initialize(self, servable_dir, device="cuda"):
        from pnp_vcve_torch.apis import init_model

        root = Path(servable_dir)
        self.manifest = json.loads((root / "MANIFEST.json").read_text())
        meta = self.manifest["model"]
        self.model_name = meta["modelName"]
        weights = meta.get("serializedFile")
        self.model = init_model(str(root / meta["configFile"]),
                                str(root / weights) if weights else None, device=device)
        self.initialized = True

    def preprocess(self, body: bytes):
        import numpy as np
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.float32) / 255.0

    def inference(self, img):
        import torch

        from pnp_vcve_torch.apis import restoration_inference

        with self._lock, torch.inference_mode():
            return restoration_inference(self.model, img)

    def postprocess(self, out) -> bytes:
        from PIL import Image

        from pnp_vcve_torch.metrics import tensor2img

        buf = io.BytesIO()
        Image.fromarray(tensor2img(out)).save(buf, format="PNG")
        return buf.getvalue()

    def handle(self, body: bytes) -> bytes:
        return self.postprocess(self.inference(self.preprocess(body)))


def make_server(handler: PnPServingHandler, port: int = 8080) -> ThreadingHTTPServer:
    """The inference API on the standard library's HTTP server, bound to
    127.0.0.1."""

    class _H(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/ping":
                self.send_error(404)
                return
            payload = json.dumps({"status": "Healthy"}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path != f"/predictions/{handler.model_name}":
                self.send_error(404, "unknown model")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                png = handler.handle(body)
            except Exception as e:  # answered as a 500; the server keeps serving
                self.send_error(500, str(e).splitlines()[0][:200] if str(e) else type(e).__name__)
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), _H)


def serve_background(handler: PnPServingHandler, port: int = 0):
    """Serve on a daemon thread -> ``(server, port)``; stop it with
    ``server.shutdown(); server.server_close()``."""
    srv = make_server(handler, port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve a PnP-VCVE servable over HTTP")
    p.add_argument("servable_dir")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    h = PnPServingHandler()
    h.initialize(args.servable_dir, device=args.device)
    srv = make_server(h, args.port)
    print(f"serving {h.model_name} on 127.0.0.1:{srv.server_address[1]} "
          f"(POST /predictions/{h.model_name}, GET /ping)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
