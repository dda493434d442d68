"""COLMAP sparse-model readers (binary and text).

Fresh implementation of the public COLMAP model format (the reference vendors
the ETH/UNC reader, ``data_utils/poses/colmap_read_model.py``).  Only the
pieces the pose pipeline needs: cameras, images (poses + 2D-3D tracks), and
3D points.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# camera model id -> (name, num_params); COLMAP's registry.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # w, x, y, z
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray

    def rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cameras[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            # Each 2D point record: x (f8), y (f8), point3D_id (i8).
            rec = np.fromfile(
                f, dtype=np.dtype([("xy", "<f8", 2), ("pid", "<i8")]),
                count=num_pts,
            )
            xys = rec["xy"].copy()
            point3d_ids = rec["pid"].copy()
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, point3d_ids,
            )
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], dtype=np.uint8)
            error = vals[7]
            (track_len,) = _read(f, "<Q")
            track = np.fromfile(f, dtype=np.int32, count=2 * track_len)
            track = track.reshape(track_len, 2)
            points[pid] = Point3D(
                pid, xyz, rgb, error, track[:, 0].copy(), track[:, 1].copy()
            )
    return points


# --------------------------------------------------------------------------
# Text format.  One record per line ('#' comments skipped); images use two
# lines per record.  Same dispatch surface as the reference's read_model
# (colmap_read_model.py:260-270), which falls back to .txt models.
# --------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, Camera]:
    """cameras.txt: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]"""
    cameras = {}
    for line in _data_lines(path):
        toks = line.split()
        cam_id = int(toks[0])
        cameras[cam_id] = Camera(
            cam_id, toks[1], int(toks[2]), int(toks[3]),
            np.array(toks[4:], dtype=np.float64),
        )
    return cameras


def read_images_text(path: str) -> Dict[int, Image]:
    """images.txt: two lines per image —
    IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
    then (X Y POINT3D_ID)*.  The track line is EMPTY for an image with no
    observations, so blank lines only count as data after a header line."""
    images = {}
    head = None
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if head is None:
                if not line or line.startswith("#"):
                    continue
                head = line
                continue
            track = line
            toks = head.split()
            head = None
            image_id = int(toks[0])
            flat = np.array(track.split(), dtype=np.float64).reshape(-1, 3)
            images[image_id] = Image(
                image_id,
                np.array(toks[1:5], dtype=np.float64),
                np.array(toks[5:8], dtype=np.float64),
                int(toks[8]),
                toks[9],
                flat[:, :2].copy(),
                flat[:, 2].astype(np.int64),
            )
    if head is not None:
        raise ValueError(f"images.txt truncated: dangling header in {path}")
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    """points3D.txt: POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)*"""
    points = {}
    for line in _data_lines(path):
        toks = line.split()
        pid = int(toks[0])
        track = np.array(toks[8:], dtype=np.int64).reshape(-1, 2)
        points[pid] = Point3D(
            pid,
            np.array(toks[1:4], dtype=np.float64),
            np.array(toks[4:7], dtype=np.uint8),
            float(toks[7]),
            track[:, 0].copy(),
            track[:, 1].copy(),
        )
    return points


def detect_model_format(sparse_dir: str) -> str:
    """'.bin' if a binary model is present, else '.txt'; error if neither."""
    for ext in (".bin", ".txt"):
        if all(
            os.path.isfile(os.path.join(sparse_dir, name + ext))
            for name in ("cameras", "images", "points3D")
        ):
            return ext
    raise FileNotFoundError(
        f"no COLMAP model (cameras/images/points3D .bin or .txt) in {sparse_dir}"
    )


def read_model(sparse_dir: str, ext: str = ""):
    """Read a COLMAP sparse model directory, binary or text
    (reference colmap_read_model.py:260-270 dispatches the same way;
    ``ext`` empty = auto-detect, preferring binary)."""
    ext = ext or detect_model_format(sparse_dir)
    join = lambda name: os.path.join(sparse_dir, name + ext)
    if ext == ".bin":
        return (
            read_cameras_binary(join("cameras")),
            read_images_binary(join("images")),
            read_points3d_binary(join("points3D")),
        )
    return (
        read_cameras_text(join("cameras")),
        read_images_text(join("images")),
        read_points3d_text(join("points3D")),
    )
