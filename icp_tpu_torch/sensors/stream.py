"""Streaming frame source for recorded .bin cloud sequences (port of
``icp_tpu.sensors.stream``).

The read side of the reference's capture loop (kinect_frame_grabber,
src/kinect_frame_grabber.cpp, which writes 640x480 float8 ``.bin`` clouds):
a native prefetch thread (native/frame_source.cpp, through the port's
loader ``icp_tpu_torch.runtime.native``) keeps a ring of decoded frames
ahead of the consumer, so the registration loop never waits on the disk.
Without the native library it reads synchronously with numpy.

Usage::

    with FrameSource("/data/run1", n_points=640*480) as src:
        for idx, cloud in src:          # cloud: (n_points, 8) float32 numpy
            lms = frame_to_landmarks(cloud)  # numpy frames go to the card
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from icp_tpu_torch.runtime import native as _native


class FrameSource:
    """Iterates (frame_index, (n_points, 8) float32) over a directory of
    ``.bin`` clouds in sorted filename order."""

    def __init__(self, directory: str, n_points: int = 640 * 480, ring: int = 4):
        self._dir = str(directory)
        self._n = int(n_points)
        self._handle = None
        self._fallback_files: Optional[list] = None
        self._fallback_pos = 0

        lib = _native.load()
        if lib is not None:
            self._handle = lib.fs_open(self._dir.encode(), self._n, int(ring))
            self._lib = lib
        if self._handle is None:
            self._fallback_files = sorted(glob.glob(os.path.join(self._dir, "*.bin")))

    @property
    def native(self) -> bool:
        """Whether frames come from the native prefetch ring."""
        return self._handle is not None

    def __len__(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_count(self._handle))
        return len(self._fallback_files)

    def next_frame(self) -> Optional[Tuple[int, np.ndarray]]:
        """Next (index, cloud) or None at the end of the stream."""
        if self._handle is not None:
            out = np.empty((self._n, 8), np.float32)
            idx = self._lib.fs_next(self._handle, _native._fptr(out))
            if idx < 0:
                return None
            return int(idx), out
        if self._fallback_pos >= len(self._fallback_files):
            return None
        path = self._fallback_files[self._fallback_pos]
        idx = self._fallback_pos
        self._fallback_pos += 1
        raw = np.fromfile(path, np.float32)
        out = np.zeros((self._n, 8), np.float32)
        rows = min(raw.size // 8, self._n)
        out[:rows] = raw[:rows * 8].reshape(-1, 8)
        return idx, out

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        while True:
            item = self.next_frame()
            if item is None:
                return
            yield item

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fs_close(self._handle)
            self._handle = None

    def __enter__(self) -> "FrameSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
