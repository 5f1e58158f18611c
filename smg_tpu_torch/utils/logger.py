"""Run logging: the reference Logger's directory tree and transitions logs
(port of smg_tpu/utils/logger.py).

- timestamped run tree `logs/<ts>/{info, data/color|depth-heightmaps,
  models, visualizations, transitions}` (reference logger.py:11-76);
- camera / heightmap info files (logger.py:78-85);
- the ten append-only `<name>.log.txt` arrays, rows in %.18e as
  np.savetxt writes them (logger.py:118-119), so the reference's plotting
  scripts and scripts/analyze_results.py read them. All ten exist from the
  start, as in the reference, which rewrote every array each iteration;
- a `<name>.log.bin` float32 mirror of each through the native library's
  writer thread (utils/native.py), skipped when the library cannot load.
  A mirror that a resumed run reopens starts with the rows it held (the
  native writer truncates the file it opens);
- heightmap / visualization snapshots as .npy, plus .png when pillow is
  importable.

Rows are handed to a writer thread, which formats and flushes them, so
text IO never blocks the step loop; `flush` waits for them.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Iterable

import numpy as np

from smg_tpu_torch.utils import native as native_mod

LOG_NAMES = (
    "executed-action",
    "label-value",
    "reward-value",
    "predicted-value",
    "use-heuristic",
    "is-exploit",
    "clearance",
    "grasping_type",
    "episode_success",
    "training_loss",
)


class Logger:
    def __init__(self, continue_logging: bool = False,
                 logging_directory: str = "logs"):
        if continue_logging:
            self.base_directory = os.path.abspath(logging_directory)
            print(f"Pre-loading data logging session: {self.base_directory}")
        else:
            timestamp = time.strftime("%Y-%m-%d.%H:%M:%S")
            self.base_directory = os.path.join(
                os.path.abspath(logging_directory), timestamp
            )
            print(f"Creating data logging session: {self.base_directory}")
        self.info_directory = os.path.join(self.base_directory, "info")
        self.color_heightmaps_directory = os.path.join(
            self.base_directory, "data", "color-heightmaps"
        )
        self.depth_heightmaps_directory = os.path.join(
            self.base_directory, "data", "depth-heightmaps"
        )
        self.models_directory = os.path.join(self.base_directory, "models")
        self.visualizations_directory = os.path.join(
            self.base_directory, "visualizations"
        )
        self.transitions_directory = os.path.join(
            self.base_directory, "transitions"
        )
        for d in (
            self.info_directory, self.color_heightmaps_directory,
            self.depth_heightmaps_directory, self.models_directory,
            self.visualizations_directory, self.transitions_directory,
        ):
            os.makedirs(d, exist_ok=True)
        self._files = {name: open(self._log_path(name, "txt"), "a")
                       for name in LOG_NAMES}
        self._mirrors = {}
        self._native_ok = native_mod.load_library() is not None
        self._queue: queue.Queue = queue.Queue()
        self._pending = 0
        self._drained = threading.Condition()
        self._writer_exc: BaseException | None = None
        self._thread: threading.Thread | None = threading.Thread(
            target=self._writer_loop, daemon=True, name="smg-logger-writer")
        self._thread.start()

    def _log_path(self, log_name: str, ext: str) -> str:
        return os.path.join(self.transitions_directory,
                            f"{log_name}.log.{ext}")

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write_rows(*item)
            except BaseException as e:  # surfaced on flush()/close()
                self._writer_exc = e
            finally:
                with self._drained:
                    self._pending -= 1
                    if self._pending == 0:
                        self._drained.notify_all()

    def flush(self) -> None:
        """Block until every enqueued row hit the filesystem."""
        with self._drained:
            while self._pending > 0:
                self._drained.wait()
        if self._writer_exc is not None:
            exc, self._writer_exc = self._writer_exc, None
            raise exc

    # -- info (logger.py:78-85) -----------------------------------------

    def save_camera_info(self, intrinsics, pose, depth_scale):
        np.savetxt(
            os.path.join(self.info_directory, "camera-intrinsics.txt"),
            np.asarray(intrinsics), delimiter=" ",
        )
        np.savetxt(
            os.path.join(self.info_directory, "camera-pose.txt"),
            np.asarray(pose), delimiter=" ",
        )
        np.savetxt(
            os.path.join(self.info_directory, "camera-depth-scale.txt"),
            np.asarray([depth_scale]), delimiter=" ",
        )

    def save_heightmap_info(self, workspace_limits, heightmap_resolution):
        np.savetxt(
            os.path.join(self.info_directory, "heightmap-boundaries.txt"),
            np.asarray(workspace_limits), delimiter=" ",
        )
        np.savetxt(
            os.path.join(self.info_directory, "heightmap-resolution.txt"),
            np.asarray([heightmap_resolution]), delimiter=" ",
        )

    def save_config(self, cfg_dict: dict):
        with open(os.path.join(self.info_directory, "config.json"), "w") as f:
            json.dump(cfg_dict, f, indent=2, default=str)

    # -- transitions (logger.py:118-119) ---------------------------------

    def write_to_log(self, log_name: str, rows: Iterable) -> None:
        """Append rows to `<name>.log.txt` (space-separated, %.18e like
        np.savetxt's default, format-compatible with the reference).

        The rows are copied and handed to the writer thread; call flush()
        (or close()) to wait for them on disk.
        """
        arr = np.atleast_2d(np.asarray(rows, dtype=np.float64)).copy()
        with self._drained:
            self._pending += 1
        self._queue.put((log_name, arr))

    def _mirror(self, log_name: str) -> native_mod.AsyncBinaryLog:
        mirror = self._mirrors.get(log_name)
        if mirror is None:
            path = self._log_path(log_name, "bin")
            old = (native_mod.read_binary_log(path)
                   if os.path.exists(path) else [])
            mirror = native_mod.AsyncBinaryLog(path)
            for row in old:
                mirror.append(row)
            self._mirrors[log_name] = mirror
        return mirror

    def _write_rows(self, log_name: str, arr: np.ndarray) -> None:
        f = self._files[log_name]
        for row in arr:
            f.write(" ".join(f"{v:.18e}" for v in row) + "\n")
        f.flush()
        if self._native_ok:
            mirror = self._mirror(log_name)
            for row in arr:
                mirror.append(row)

    def read_log(self, log_name: str) -> np.ndarray:
        """A log's rows as (rows, columns); (0, 0) while it has none."""
        self.flush()
        path = self._log_path(log_name, "txt")
        if os.path.getsize(path) == 0:
            return np.zeros((0, 0))
        return np.loadtxt(path, delimiter=" ", ndmin=2)

    # -- imagery ----------------------------------------------------------

    @staticmethod
    def _save_png(path: str, img: np.ndarray) -> None:
        """uint8/uint16 image -> PNG (the reference saves cv2 PNGs,
        logger.py:87-104); skipped if pillow is unavailable."""
        try:
            from PIL import Image
        except ImportError:
            return
        Image.fromarray(img).save(path)

    def save_heightmaps(self, iteration: int, color_heightmap,
                        depth_heightmap, mode: str = "0") -> None:
        """Color (H, W, 3 in [0, 1]) and depth (H, W meters) heightmaps.

        PNG layout as the reference's (logger.py:94-104): color as uint8
        RGB, depth scaled x100000 into uint16; the float arrays are kept
        as .npy too.
        """
        color = np.asarray(color_heightmap)
        depth = np.asarray(depth_heightmap)
        cstem = os.path.join(
            self.color_heightmaps_directory, f"{iteration:06d}.{mode}.color"
        )
        dstem = os.path.join(
            self.depth_heightmaps_directory, f"{iteration:06d}.{mode}.depth"
        )
        np.save(cstem + ".npy", color)
        np.save(dstem + ".npy", depth)
        self._save_png(
            cstem + ".png",
            np.clip(color * 255.0, 0, 255).astype(np.uint8),
        )
        self._save_png(
            dstem + ".png",
            np.clip(depth * 100000.0, 0, 65535).astype(np.uint16),
        )

    def save_images(self, iteration: int, color_image, depth_image,
                    mode: str = "0") -> None:
        """Raw camera RGB-D (reference logger.py:87-92: color PNG + depth
        x10^4 uint16 PNG) under data/color-images and data/depth-images."""
        color = np.asarray(color_image)
        depth = np.asarray(depth_image)
        data = os.path.dirname(self.color_heightmaps_directory)
        cpath = os.path.join(data, "color-images")
        dpath = os.path.join(data, "depth-images")
        os.makedirs(cpath, exist_ok=True)
        os.makedirs(dpath, exist_ok=True)
        np.save(
            os.path.join(cpath, f"{iteration:06d}.{mode}.color.npy"), color
        )
        self._save_png(
            os.path.join(cpath, f"{iteration:06d}.{mode}.color.png"),
            np.clip(color * 255.0, 0, 255).astype(np.uint8),
        )
        self._save_png(
            os.path.join(dpath, f"{iteration:06d}.{mode}.depth.png"),
            np.clip(depth * 10000.0, 0, 65535).astype(np.uint16),
        )

    def save_visualizations(self, iteration: int, affordance_vis, name: str):
        arr = np.asarray(affordance_vis)
        stem = os.path.join(
            self.visualizations_directory, f"{iteration:06d}.{name}"
        )
        np.save(stem + ".npy", arr)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            self._save_png(
                stem + ".png",
                np.clip(arr * 255.0, 0, 255).astype(np.uint8),
            )

    def close(self):
        if self._thread is not None:
            self.flush()
            self._queue.put(None)
            self._thread.join(timeout=10.0)
            self._thread = None
        for f in self._files.values():
            f.close()
        self._files.clear()
        for m in self._mirrors.values():
            m.close()
        self._mirrors.clear()
