"""Dependency-free MJPEG-AVI video recorder for evaluation runs (a copy of
`lav_tpu/utils/video.py`).

The reference agent accumulates every tick's visualization canvas and
flushes it to wandb as a 20-fps mp4 (LAV team_code_v2/
lav_agent.py:158-165).  To need no mp4 encoder (ffmpeg, imageio video
backends), this module writes Motion-JPEG inside a
hand-rolled RIFF/AVI container — PIL's JPEG encoder is the only
dependency, and the output plays in every mainstream player.
"""

from __future__ import annotations

import io
import struct
from typing import Optional

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class VideoRecorder:
    """Streamed MJPEG AVI writer.

        rec = VideoRecorder("run.avi", fps=20)
        rec.append(frame_uint8_hwc)
        ...
        rec.close()

    Frames must share one (H, W, 3) shape.  max_frames mirrors the
    reference's <=12000-frame flush cap (lav_agent.py:30, 158-165): the
    recorder silently stops appending past it.
    """

    def __init__(self, path: str, fps: int = 20, quality: int = 85,
                 max_frames: int = 12000):
        self.path = path
        self.fps = fps
        self.quality = quality
        self.max_frames = max_frames
        self._chunks: list = []
        self._wh: Optional[tuple] = None

    def append(self, frame: np.ndarray):
        if len(self._chunks) >= self.max_frames:
            return
        frame = np.ascontiguousarray(np.asarray(frame, np.uint8))
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, -1)
        if self._wh is None:
            self._wh = (frame.shape[1], frame.shape[0])
        assert (frame.shape[1], frame.shape[0]) == self._wh, (
            f"frame size changed: {frame.shape} vs {self._wh}"
        )
        self._chunks.append(_jpeg_bytes(frame, self.quality))

    def __len__(self) -> int:
        return len(self._chunks)

    def close(self) -> Optional[str]:
        if not self._chunks:
            return None
        w, h = self._wh
        n = len(self._chunks)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) % 2 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(kind: bytes, payload: bytes) -> bytes:
            body = kind + payload
            pad = b"\x00" if len(body) % 2 else b""
            return b"LIST" + struct.pack("<I", len(body)) + body + pad

        avih = struct.pack(
            "<14I",
            1_000_000 // self.fps,  # dwMicroSecPerFrame
            0, 0,
            0x10,                   # AVIF_HASINDEX
            n, 0, 1, 0, w, h,
            0, 0, 0, 0,
        )
        strh = (
            b"vids" + b"MJPG"
            # dwFlags, wPriority, wLanguage, dwInitialFrames, dwScale,
            # dwRate, dwStart, dwLength, dwSuggestedBufferSize, dwQuality,
            # dwSampleSize
            + struct.pack("<IHH8I", 0, 0, 0, 0, 1, self.fps, 0, n,
                          0, 0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h)
        )
        strf = struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0
        )
        hdrl = lst(
            b"hdrl",
            chunk(b"avih", avih)
            + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
        )

        movi_body = b"".join(chunk(b"00dc", c) for c in self._chunks)
        movi = lst(b"movi", movi_body)

        idx, off = [], 4  # offsets relative to the 'movi' fourcc
        for c in self._chunks:
            size = len(c)
            idx.append(struct.pack("<4sIII", b"00dc", 0x10, off, size))
            off += 8 + size + (size % 2)
        idx1 = chunk(b"idx1", b"".join(idx))

        body = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
        self._chunks.clear()
        return self.path
