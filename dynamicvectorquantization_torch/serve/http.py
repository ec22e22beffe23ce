"""HTTP front end over the dynamic-batching sampler (counterpart of
`scripts/serve.py`), standard library only:

    python -m dynamicvectorquantization_torch.serve \\
        --yaml_path configs/stage2/uncond_imagenet_p6c18.yml --model_path <checkpoint> \\
        --port 8000 --max_batch 16 --kv_cache_dtype int8 [--device cpu]

  POST /generate  {"num_images": 2, "seed": 7}
      -> {"images": [<base64 PNG>, ...], "batch": <batches run>}
  GET  /healthz   -> {"ok": true, "batches_run": n, "images_served": m, "max_batch": k}

An unknown path answers 404, a request the sampler refuses (`num_images`
outside [1, max_batch], a body that is not JSON) 400, any other failure 500.
Concurrent requests coalesce into batches in `serve/server.py`
`BatchingSampler`; requests carry no class label, as the JAX server's do
not (a class model conditions on label 0). The PNGs are written by
`utils/logging.py` `encode_png` (no PIL). The model loads through
`utils/model_loading.py` `load_model_and_variables`, on the CUDA card
unless `--device` names another device; one image is generated before the
server starts listening.
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import encode_png, to_uint8
from ..utils.model_loading import load_model_and_variables
from .server import BatchingSampler


def get_parser():
    p = argparse.ArgumentParser(description="dqvq HTTP sampling server (PyTorch + CUDA)")
    p.add_argument("--yaml_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=30.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--top_k_pos", type=int, default=1024)
    p.add_argument("--kv_cache_dtype", type=str, default=None, choices=("int8",))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain-PyTorch versions")
    return p


def png_b64(image) -> str:
    """A [-1, 1] float (H, W, 3) image -> a base64 PNG."""
    return base64.b64encode(encode_png(to_uint8(image))).decode("ascii")


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {"ok": True, "batches_run": engine.batches_run,
                              "images_served": engine.images_served,
                              "max_batch": engine.max_batch})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                images = engine.generate(int(req.get("num_images", 1)), req.get("seed"))
                self._reply(200, {"images": [png_b64(im) for im in images],
                                  "batch": engine.batches_run})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # the server's boundary: report, keep serving
                self._reply(500, {"error": repr(e)})

        def log_message(self, fmt, *args):  # no access log
            pass

    return Handler


def make_server(engine, host="127.0.0.1", port=8000) -> ThreadingHTTPServer:
    """A threaded server answering for `engine` (port 0: any free port,
    `server.server_address[1]`); the caller runs `serve_forever`."""
    return ThreadingHTTPServer((host, port), make_handler(engine))


def main(argv=None):
    opt = get_parser().parse_args(argv)
    model, _ = load_model_and_variables(opt.yaml_path, opt.model_path, opt.seed,
                                        opt.kv_cache_dtype, device=opt.device)
    with BatchingSampler(model, max_batch=opt.max_batch, max_wait_ms=opt.max_wait_ms,
                         temperature=opt.temperature, top_k=opt.top_k,
                         top_k_pos=opt.top_k_pos) as engine:
        print(f"warming up (a batch of {opt.max_batch})...", file=sys.stderr, flush=True)
        engine.generate(1, seed=0)
        server = make_server(engine, opt.host, opt.port)
        print(f"serving on http://{opt.host}:{server.server_address[1]}", file=sys.stderr,
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    return 0
