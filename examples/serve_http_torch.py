"""Minimal prediction service over a serving artifact of the PyTorch
port.

The protocol of `examples/serve_http.py`, with nothing but the standard
library, numpy and the port's kernel ops: load a `.pt2` artifact written by
`pivp_tpu_torch.inference.export_cli` (no model code needed, but
`pivp_tpu_torch.ops.kernels` must be importable, which registers the
kernels the artifact calls) and serve batched video predictions over
HTTP.

Protocol:
  POST /predict   body = npz with arrays `images` (ctx, B, H, W, C)
                  float32 in [0,1], `actions` (T-1, B, A), `state0`
                  (B, S), at the artifact's batch; response = npz with
                  `frames` (T-ctx, B, H, W, C) uint8.
  GET  /healthz   200 "ok" once the artifact is loaded and warmed up.

A body that is not such an npz, or whose arrays do not have the
artifact's input shapes (a wrong batch) or a type that casts to them,
gets a 400; a failure on the device a 500. One request at a time runs
on the device.

Run:  python examples/serve_http_torch.py ARTIFACT.pt2 [--port 8000]
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger("pivp-serve-torch")

INPUTS = ("images", "actions", "state0")


def _request_arrays(body: bytes, specs) -> tuple:
    """The request's arrays, checked against `specs` ((shape, numpy
    dtype) of each input) and cast to their types; raises ValueError on
    a mismatch."""
    with np.load(io.BytesIO(body)) as z:
        arrays = tuple(np.asarray(z[name]) for name in INPUTS)
    out = []
    for name, a, (shape, dtype) in zip(INPUTS, arrays, specs):
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, the artifact "
                             f"takes {shape}")
        if not np.can_cast(a.dtype, dtype, casting="same_kind"):
            raise ValueError(f"{name} is {a.dtype}, the artifact takes "
                             f"{dtype}")
        out.append(a.astype(dtype, copy=False))
    return tuple(out)


def make_server(artifact_path: str, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Load and warm up the artifact, and return the server (not yet
    serving); the loaded artifact is its `artifact` attribute."""
    import torch

    from pivp_tpu_torch.inference import export as export_lib

    serve = export_lib.load_serving_artifact(artifact_path)
    specs = tuple((s.shape, torch.empty(0, dtype=s.dtype).numpy().dtype)
                  for s in serve.in_specs)
    # Warm up (the kernels build at their first launch) so the first
    # request is fast.
    serve(*(np.zeros(shape, dtype) for shape, dtype in specs)).cpu()
    logger.info("Loaded %s on %s: inputs %s", artifact_path, serve.device,
                [shape for shape, _ in specs])

    lock = threading.Lock()  # one device dispatch at a time

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, e: Exception):
            self._reply(code, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(),
                "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                args = _request_arrays(self.rfile.read(length), specs)
            # An undecodable payload (not an npz, a missing array) or
            # arrays that do not fit the artifact: the client's error.
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                self._error(400, e)
                return
            try:
                with lock:
                    frames = serve(*args).cpu().numpy()
                out = io.BytesIO()
                np.savez_compressed(out, frames=frames)
                self._reply(200, out.getvalue())
            except Exception as e:  # device OOM, a failed launch, ...
                logger.exception("predict failed")
                self._error(500, e)

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.artifact = serve
    return httpd


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    httpd = make_server(a.artifact, a.host, a.port)
    logger.info("Serving on http://%s:%d", *httpd.server_address)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
