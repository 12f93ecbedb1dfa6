"""The HTTP matcher: the port of the JAX package's ``gims_tpu/cli/serve_cli.py``.

The reference exposes a hosted endpoint
``find_matches(image0, image1, resize_enabled) -> (visualization, details)``
(reference: README.md:166-191). This module gives that API as a stdlib
HTTP service bound to 127.0.0.1: POST two images (multipart fields
``image0`` and ``image1``, and ``resize_enabled=0`` to keep their size) to
``/find_matches`` and get the match drawing as PNG, with a JSON summary in
the ``X-Match-Details`` header. Uploads are decoded with the port's
``imdecode`` (PNG, baseline JPEG, BMP) on the matcher's device; other
paths answer 404 and a request that fails 500. ``make_server`` returns the
``HTTPServer`` (port 0 picks a free one) so that a caller can drive it
from a thread; ``serve`` runs it. It runs on ``cuda`` unless ``--device
cpu``. JAX's CLI first turns on its persistent compilation cache
(``core/cache.py``); the port has no counterpart to call, since its CUDA
kernels are built once and cached by ``_build.py``.

    python -m gims_tpu_torch.cli.serve_cli --port 7860 &
    curl -F image0=@a.jpg -F image1=@b.jpg \\
         http://127.0.0.1:7860/find_matches -o out.png
"""

from __future__ import annotations

import argparse
import json
import time

from gims_tpu_torch.core import image_io, imgproc


def find_matches(matcher, image0, image1, resize_enabled=True, resize=(800, 600), agc=None):
    """The reference demo's function surface. Returns (viz_bgr, details)."""
    from gims_tpu_torch.eval.viz import draw_matches
    from gims_tpu_torch.fused import FusedMatching

    if resize_enabled:
        image0 = imgproc.resize(image0, resize)
        image1 = imgproc.resize(image1, resize)
    t0 = time.perf_counter()
    if isinstance(matcher, FusedMatching):
        pred = matcher(image0, image1)
    else:
        pred = matcher({
            "image0": image0[None], "image1": image1[None],
            **(agc or {"radius": 15, "percentile": 2, "min_size": 7}),
            "return_descriptors": False,
        })
    dt = time.perf_counter() - t0
    kpts0 = pred["keypoints0"][0]
    kpts1 = pred["keypoints1"][0]
    matches = pred["matches0"][0]
    valid = matches > -1
    viz = draw_matches(image0, image1, kpts0[valid], kpts1[matches[valid]])
    details = {
        "keypoints0": int(len(kpts0)),
        "keypoints1": int(len(kpts1)),
        "matches": int(valid.sum()),
        "seconds": round(dt, 3),
        "timings": {k: round(v, 3) for k, v in matcher.timings.items()},
    }
    return viz, details


def _parse_multipart(handler):
    import email
    import email.policy

    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP,
    )
    files = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            files[name] = part.get_payload(decode=True)
    return files


def encode_multipart(fields, boundary="gims-boundary"):
    """(body, content type) of a multipart/form-data POST of `fields`
    ({name: bytes}), as a browser's form or ``curl -F`` sends them."""
    parts = []
    for name, data in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                     f"filename=\"{name}\"\r\nContent-Type: application/octet-stream\r\n\r\n"
                     .encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def build_matcher(weights_path=None, fused=False, total_keypoints=12288, device=None):
    """The JAX server's two matcher configurations."""
    if fused:
        # the fused single-program path (fused.py): detection on the device and
        # dense_gray descriptors, one dispatch per request
        from gims_tpu_torch.core.checkpoint import unflatten_npz
        from gims_tpu_torch.fused import FusedMatching

        return FusedMatching({
            "sinkhorn_iterations": 20,
            "match_threshold": 0.02,
            "fast_frontend": True,
            "descriptor_source": "dense_gray",
            "attention_dtype": "bfloat16",
            "radius": 15, "percentile": 2, "min_size": 7,
            "init_scheme": "identity",
        }, variables=(unflatten_npz(weights_path) if weights_path else None),
            total_keypoints=total_keypoints, device=device)
    from gims_tpu_torch.api import Matching

    return Matching({
        "weights_path": weights_path,
        "sinkhorn_iterations": 20,
        "match_threshold": 0.02,
        "max_keypoints": -1,
    }, device=device)


def make_server(port=7860, weights_path=None, fused=False, total_keypoints=12288,
                device=None, matcher=None):
    """The matcher's ``HTTPServer`` on 127.0.0.1:`port` (0 picks a free
    port), not yet serving. `matcher` replaces the configured one."""
    import http.server

    if matcher is None:
        matcher = build_matcher(weights_path, fused, total_keypoints, device)

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path.rstrip("/") != "/find_matches":
                self.send_error(404)
                return
            try:
                files = _parse_multipart(self)
                img0 = image_io.imdecode(files["image0"], image_io.IMREAD_COLOR,
                                         device=matcher.device)
                img1 = image_io.imdecode(files["image1"], image_io.IMREAD_COLOR,
                                         device=matcher.device)
                resize_enabled = files.get("resize_enabled", b"1") != b"0"
                viz, details = find_matches(matcher, img0, img1, resize_enabled)
                png = image_io.encode_png(viz)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Match-Details", json.dumps(details))
                self.end_headers()
                self.wfile.write(png)
            except Exception as e:  # noqa: BLE001
                self.send_error(500, str(e))

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(
                b"<html><body><h1>GIMS-TPU matcher</h1>"
                b"<form action='/find_matches' method='post' "
                b"enctype='multipart/form-data'>"
                b"<input type='file' name='image0'/>"
                b"<input type='file' name='image1'/>"
                b"<input type='submit' value='Match'/></form></body></html>"
            )

    server = http.server.HTTPServer(("127.0.0.1", port), Handler)
    server.matcher = matcher
    return server


def serve(port=7860, weights_path=None, fused=False, total_keypoints=12288, device=None):
    server = make_server(port, weights_path, fused, total_keypoints, device)
    print(f"Serving GIMS-TPU matcher on http://127.0.0.1:{server.server_address[1]}")
    server.serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--fused", action="store_true",
                        help="serve the fused single-program pipeline "
                             "(device detection + dense_gray descriptors)")
    parser.add_argument("--total_keypoints", type=int, default=12288,
                        help="--fused keypoint budget")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)
    serve(args.port, args.weights_path, fused=args.fused,
          total_keypoints=args.total_keypoints, device=args.device)


if __name__ == "__main__":
    main()
