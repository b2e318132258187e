"""Service transport: the four reference service schemas over HTTP/JSON.

Counterpart of ``rovinasemanticsegmentation_tpu/serve/services.py`` serving
the port's :class:`~.segmenter.Segmenter` (copied: the reference module
imports the reference ``Segmenter``). ROS is out of scope; the external RPC
surface mirrors the ``srv`` schemas (``srv/*.srv``) as JSON endpoints:

- ``GET  /semantic_segmentation/local_map_ids``         (IdsSrv)
- ``POST /semantic_segmentation/get_local_map_segmentation``
  body {"local_map_id": int, "segmentation_layers": [str]}
  (LocalMapSegmentationSrv)
- ``GET  /semantic_segmentation/information``           (SegmentationInformationSrv)
- ``POST /semantic_segmentation/single_frame_segmentation``
  body {"rgb": b64 u8 [H,W,3], "depth": b64 f32 [H,W,3], "height": H,
  "width": W} -> {"label_distribution": [float]} (SingleFrameSegmentation)

:func:`heuristic_single_frame_segmentation` ports the reference's Python stub
network (``scripts/single_frame_segmentation_server.py:12-52``): a
height-thresholded floor/wall/ceiling prior over the rectified depth's
z-channel, replicated per layer.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np

from .segmenter import Segmenter


def heuristic_single_frame_segmentation(
    rgb: np.ndarray,  # [H, W, 3]
    depth3d: np.ndarray,  # [H, W, 3] rectified world coordinates
    class_counts: Sequence[int],
) -> List[np.ndarray]:
    """Stub posteriors: z<=0 -> uniform(3), 0<z<=0.5 floor, <=1.5 wall, else
    ceiling (single_frame_segmentation_server.py:24-44). Returns per-layer
    [H, W, C] arrays."""
    h, w = rgb.shape[:2]
    z = np.nan_to_num(depth3d[..., 2])
    out: List[np.ndarray] = []
    for c in class_counts:
        p = np.zeros((h, w, c), dtype=np.float32)
        p[..., :3] = 1.0 / 3.0
        floor = z > 0
        wall = z > 0.5
        ceil = z > 1.5
        p[floor, 0], p[floor, 1], p[floor, 2] = 1.0, 0.0, 0.0
        p[wall, 0], p[wall, 1], p[wall, 2] = 0.0, 1.0, 0.0
        p[ceil, 0], p[ceil, 1], p[ceil, 2] = 0.0, 0.0, 1.0
        out.append(p)
    return out


def _b64_array(data: str, dtype, shape) -> np.ndarray:
    buf = base64.b64decode(data)
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


class SegmentationServiceServer:
    """HTTP server exposing a Segmenter's query services."""

    def __init__(self, segmenter: Segmenter, host: str = "127.0.0.1", port: int = 0):
        self.segmenter = segmenter
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/semantic_segmentation/local_map_ids":
                    self._send(
                        200,
                        {"local_map_ids": outer.segmenter.stored_semantics_ids()},
                    )
                elif self.path == "/semantic_segmentation/information":
                    self._send(200, outer.segmenter.segmentation_information())
                else:
                    self._send(404, {"error": "unknown service"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON"})
                    return
                if self.path == "/semantic_segmentation/get_local_map_segmentation":
                    try:
                        result = outer.segmenter.get_local_map_segmentation(
                            int(req["local_map_id"]),
                            list(req["segmentation_layers"]),
                        )
                    except (KeyError, TypeError, ValueError) as e:
                        self._send(400, {"error": f"bad request: {e}"})
                        return
                    if result is None:
                        # The reference returns failure for unknown layers or
                        # ids (segmenter.cpp:744-746, 773).
                        self._send(404, {"error": "unknown map id or layer"})
                    else:
                        map_id, labels = result
                        self._send(
                            200, {"local_map_id": map_id, "point_labels": labels}
                        )
                elif self.path == "/semantic_segmentation/single_frame_segmentation":
                    try:
                        h, w = int(req["height"]), int(req["width"])
                        rgb = _b64_array(req["rgb"], np.uint8, (h, w, 3))
                        depth = _b64_array(req["depth"], np.float32, (h, w, 3))
                    except (KeyError, ValueError) as e:
                        self._send(400, {"error": f"bad request: {e}"})
                        return
                    dists = heuristic_single_frame_segmentation(
                        rgb, depth, outer.segmenter.layer_class_counts
                    )
                    flat = np.concatenate([d.ravel() for d in dists])
                    self._send(
                        200, {"label_distribution": [float(v) for v in flat]}
                    )
                else:
                    self._send(404, {"error": "unknown service"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5.0)
