"""Matplotlib-figure -> video encoding. Counterpart of
boardlaw_tpu/utils/recording.py.

Reference counterpart: rebar/recording.py (libx264 mp4 encoder + parallel
frame rendering). Here: frames are rendered to RGB arrays and encoded with
ffmpeg when available; otherwise kept as a raw (T, H, W, 3) array (always
retrievable via `.frames`). Only numpy is imported here; matplotlib only
where a figure is converted.
"""
from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np


def fig_to_array(fig):
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.copy()


def ffmpeg_available():
    return shutil.which("ffmpeg") is not None


class Encoder:
    """Collects matplotlib figures (or RGB arrays) as frames; `save(path)`
    writes an mp4 via ffmpeg when present."""

    def __init__(self, fps=4):
        self.fps = fps
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, frame):
        if hasattr(frame, "canvas"):
            frame = fig_to_array(frame)
        self.frames.append(np.asarray(frame))

    def array(self):
        return np.stack(self.frames) if self.frames else np.zeros((0, 0, 0, 3))

    def save(self, path):
        path = Path(path)
        if not ffmpeg_available():
            out = path.with_suffix(".npy")
            np.save(out, self.array())
            return out
        arr = self.array()
        T, H, W, _ = arr.shape
        # even dims for yuv420p
        H2, W2 = H - H % 2, W - W % 2
        arr = arr[:, :H2, :W2]
        cmd = [
            "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{W2}x{H2}", "-r", str(self.fps), "-i", "-",
            "-pix_fmt", "yuv420p", "-c:v", "libx264", str(path),
        ]
        p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                             stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        p.communicate(arr.astype(np.uint8).tobytes())
        return path
