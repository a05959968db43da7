"""Evaluation video input (UVG / MCL-JCV), ported from
fastvideocodec_tpu/data/video.py (reference VideoDataset,
dataset.py:25-127): iterates the .mp4/.yuv files of a directory frame by
frame through OpenCV, optionally resized, skipping all-black frames, and
yields (frame [H, W, 3] float32 NHWC numpy in [0, 1], end-of-file flag),
as the JAX package's does. OpenCV is imported where a file is opened, so
the package imports without it. ``ClipDataset`` keeps the same contract
over clips in memory, and ``write_yuv`` writes a clip as a UVG-style raw
.yuv file."""

from __future__ import annotations

import os

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("OpenCV required for VideoDataset") from None
    return cv2


class VideoCaptureYUV:
    """Raw YUV420 (I420) reader with a cv2.VideoCapture-like interface."""

    def __init__(self, filename: str, size=None):
        # UVG raw files are 1080p YUV420 by convention unless stated
        self.height, self.width = size if size is not None else (1080, 1920)
        self.frame_len = self.width * self.height * 3 // 2
        self.f = open(filename, "rb")
        self.shape = (int(self.height * 1.5), self.width)

    def isOpened(self):
        return not self.f.closed

    def read(self):
        raw = self.f.read(self.frame_len)
        if len(raw) < self.frame_len:
            self.f.close()
            return False, None
        yuv = np.frombuffer(raw, dtype=np.uint8).reshape(self.shape)
        return True, _cv2().cvtColor(yuv, _cv2().COLOR_YUV2BGR_I420)

    def release(self):
        if not self.f.closed:
            self.f.close()


def _open(path: str):
    return VideoCaptureYUV(path) if path.endswith(".yuv") else _cv2().VideoCapture(path)


class VideoDataset:
    """Every frame of every video file of a directory.

    ``__getitem__(i)`` -> (frame, eof) with stateful per-file counters, the
    reference's iteration contract: the index is not read, each call gives
    the next frame, and a file is loaded whole when the last one ended.
    Files are taken from the end of the sorted list. ``resolution`` is
    (width, height), as ``cv2.resize`` takes it, or None."""

    def __init__(self, root_dir: str, resolution=None, max_files: int = 0):
        _cv2()
        self._dir = root_dir
        self._frame_size = resolution
        self._total_frames = 0
        self._file_names = []
        for fn in sorted(os.listdir(root_dir)):
            fn = fn.strip("'")
            if fn.split(".")[-1] in ("mp4", "yuv"):
                self._file_names.append(os.path.join(root_dir, fn))
                if max_files > 0 and len(self._file_names) == max_files:
                    break
        self.reset()

    def reset(self):
        self._frame_counter = -1
        self._file_counter = -1
        self._dataset_nums = []
        self._clip = []
        self._cur_file_names = list(self._file_names)

    def _load_next_file(self):
        cv2 = _cv2()
        cap = _open(self._cur_file_names.pop())
        self._clip = []
        while True:
            ret, img = cap.read()
            if not ret:
                break
            if np.sum(img) == 0:  # skip black frames (dataset.py:74)
                continue
            if self._frame_size is not None:
                img = cv2.resize(img, tuple(self._frame_size), interpolation=cv2.INTER_LINEAR)
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            self._clip.append(rgb.astype(np.float32) / 255.0)
        cap.release()
        self._file_counter += 1
        self._dataset_nums.append(len(self._clip))
        self._frame_counter = 0

    def __getitem__(self, idx):
        # the reference's stateful contract (dataset.py:57-85)
        if (
            not self._dataset_nums
            or self._frame_counter >= self._dataset_nums[self._file_counter] - 1
        ):
            self._load_next_file()
        else:
            self._frame_counter += 1
        eof = self._frame_counter == self._dataset_nums[self._file_counter] - 1
        return self._clip[self._frame_counter], eof

    def __len__(self):
        if not self._total_frames:
            self._count_frames()
        return self._total_frames

    def _count_frames(self):
        self._total_frames = 0
        for path in self._file_names:
            cap = _open(path)
            while True:
                ret, img = cap.read()
                if not ret:
                    break
                if np.sum(img) != 0:
                    self._total_frames += 1
            cap.release()


class ClipDataset:
    """VideoDataset's contract over NHWC clips in memory: each call gives
    the next frame and whether it ends its clip, the clips taken from the
    end of the list as VideoDataset pops its sorted files; ``reset``
    starts over."""

    def __init__(self, clips):
        self.clips = clips
        self.reset()

    def reset(self):
        self._frames = [(f, i == len(c) - 1) for c in reversed(self.clips)
                        for i, f in enumerate(c)]
        self._next = 0

    def __len__(self):
        return sum(len(c) for c in self.clips)

    def __getitem__(self, idx):
        frame, eof = self._frames[self._next]
        self._next += 1
        return np.array(frame, np.float32), eof


def write_yuv(path, clip) -> None:
    """NHWC RGB frames in [0, 1] as raw 1920x1080 I420, as UVG ships them:
    each frame's top-left 1080 x 1920, placed on mid-grey where smaller; a
    frame of None is all black."""
    cv2 = _cv2()
    with open(path, "wb") as f:
        for frame in clip:
            full = np.zeros((1080, 1920, 3), np.uint8)
            if frame is not None:
                full[:] = 128
                h, w = min(frame.shape[0], 1080), min(frame.shape[1], 1920)
                full[:h, :w] = (frame[:h, :w, ::-1] * 255).astype(np.uint8)
            f.write(cv2.cvtColor(full, cv2.COLOR_BGR2YUV_I420).tobytes())
