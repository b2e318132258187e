"""Camera frame buffering: seq-id-indexed RGB+depth pairing.

The port's copy of ``rovinasemanticsegmentation_tpu/serve/camera.py``, kept so that
the port imports nothing of the JAX package.

Capability parity with the ``Xtion`` adapter
(``src/xtion.cpp``, ``include/xtion.h:18-61``), without ROS:
frames arrive via direct method calls (the transport adapter lives in
``serve/services.py``), and the same topic-pairing, name-parsing, buffering
and drop semantics apply:

- a camera owns exactly one color topic (contains ``rgb``/``color``) and one
  depth topic (contains ``depth``) (xtion.cpp:29-48);
- the camera name is the topic prefix, skipping a too-short first segment
  (xtion.cpp:161-171);
- ``get_id_and_clear`` pops everything older than the requested seq id,
  returns False for ids older than the last request, and raises when the id
  has not arrived yet (xtion.cpp:131-159).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

from ..utils.calibration import Calibration


def parse_name_from_topic(topic: str) -> str:
    """xtion.cpp:161-171."""
    pos = topic.find("/", 1)
    if pos == -1:
        return topic[1:] if topic.startswith("/") else topic
    if pos < 8:  # too short to contain "camera"; take the second segment too
        nxt = topic.find("/", pos + 1)
        if nxt != -1:
            pos = nxt
    return topic[1:pos]


class CameraBuffer:
    """Seq-indexed frame deques for one RGB-D camera."""

    def __init__(self, name: str):
        self.name = name
        self._color_topic: Optional[str] = None
        self._depth_topic: Optional[str] = None
        self._color: Deque[Tuple[int, np.ndarray]] = deque()
        self._depth: Deque[Tuple[int, np.ndarray]] = deque()
        self._last_id = 0
        self._calibration: Optional[Calibration] = None
        self._lock = threading.Lock()

    # -- topic pairing (xtion.cpp:29-48) --------------------------------
    def add_topic(self, topic: str) -> None:
        if "rgb" in topic or "color" in topic:
            if self._color_topic is not None:
                raise RuntimeError(
                    f"Camera {self.name} already has the color topic: "
                    f"{self._color_topic} but: {topic} should be added!"
                )
            self._color_topic = topic
        elif "depth" in topic:
            if self._depth_topic is not None:
                raise RuntimeError(
                    f"Camera {self.name} already has the depth topic: "
                    f"{self._depth_topic} but: {topic} should be added!"
                )
            self._depth_topic = topic
        else:
            raise RuntimeError(f"Missformed topic name: {topic} found")

    @property
    def is_complete(self) -> bool:
        return self._color_topic is not None and self._depth_topic is not None

    # -- calibration -----------------------------------------------------
    def set_calibration(self, calibration: Calibration) -> None:
        self._calibration = calibration

    @property
    def calibration(self) -> Calibration:
        if self._calibration is None:
            raise RuntimeError(f"Camera {self.name} has no calibration yet.")
        return self._calibration

    # -- frame ingestion (xtion.cpp:67-93) -------------------------------
    def push_color(self, seq: int, rgb: np.ndarray) -> None:
        with self._lock:
            self._color.append((int(seq), rgb))

    def push_depth(self, seq: int, depth: np.ndarray) -> None:
        with self._lock:
            self._depth.append((int(seq), depth))

    # -- retrieval (xtion.cpp:131-159) ------------------------------------
    def get_id_and_clear(
        self, seq: int
    ) -> Optional[Tuple[Tuple[int, np.ndarray], Tuple[int, np.ndarray]]]:
        """Return ((color_seq, rgb), (depth_seq, depth)) for ``seq``.

        None when the id is older than the last request (the caller drops
        the frame); raises when the id hasn't arrived on both topics yet.
        """
        with self._lock:
            if seq < self._last_id:
                return None
            if not self._color or not self._depth:
                raise RuntimeError("Requested id is not even available yet!")
            if seq > min(self._color[-1][0], self._depth[-1][0]):
                raise RuntimeError("Requested id is not even available yet!")
            while self._color and self._color[0][0] < seq:
                self._color.popleft()
            color = self._color.popleft()
            while self._depth and self._depth[0][0] < seq:
                self._depth.popleft()
            depth = self._depth.popleft()
            self._last_id = max(self._last_id, seq)
            return color, depth
