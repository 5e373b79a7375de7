"""Blender-convention camera math and depth backprojection to point
clouds (counterpart of ``genre_shapehd_tpu/utils/camera.py``; numpy).

The camera frame is y-up, z-forward (toward the camera), x-right.  The
depth map's upsampling is the bilinear resize of ``data/preprocess.py``,
which matches the JAX package's ``cv2.resize`` with ``INTER_LINEAR``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.preprocess import resize_linear


def triangle_point_budget(triangles: np.ndarray,
                          density: float) -> Tuple[np.ndarray, int]:
    """Per-triangle sample counts proportional to area (at least 1)."""
    a = triangles[:, 1] - triangles[:, 0]
    b = triangles[:, 2] - triangles[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)
    counts = np.maximum((areas * density).astype(int), 1)
    return counts, int(counts.sum())


class Camera:
    """A pinhole camera: position, orthonormal axes rx, ry, rz, resolution,
    focal length and sensor width (36 x 24 mm diagonal by default)."""

    def __init__(self):
        self.position = np.array([1.6, 0.0, 0.0])
        self.rx = np.array([0.0, 1.0, 0.0])
        self.ry = np.array([0.0, 0.0, 1.0])
        self.rz = np.array([1.0, 0.0, 0.0])
        self.res = [800, 600]
        self.focal_length = 0.05
        self.set_diagonal((0.036 ** 2 + 0.024 ** 2) ** 0.5)

    def set_diagonal(self, diag: float) -> None:
        h_rel = self.res[1] / self.res[0]
        self.sensor_width = np.sqrt(diag ** 2 / (1 + h_rel ** 2))

    def rotate(self, rot_mat: np.ndarray) -> None:
        self.rx, self.ry, self.rz = rot_mat[:, 0], rot_mat[:, 1], rot_mat[:, 2]

    def set_pose(self, inward, up) -> None:
        rx = np.cross(up, inward)
        ry = np.asarray(up, dtype=float)
        rz = np.asarray(inward, dtype=float)
        self.rx = rx / np.linalg.norm(rx)
        self.ry = ry / np.linalg.norm(ry)
        self.rz = rz / np.linalg.norm(rz)

    def lookat(self, orig, target, up) -> None:
        self.position = np.asarray(orig, dtype=float)
        inward = self.position - np.asarray(target, dtype=float)
        right = np.cross(up, inward)
        up2 = np.cross(inward, right)
        self.set_pose(inward, up2)

    def project_point(self, pt) -> Tuple[np.ndarray, np.ndarray]:
        """Global point(s) -> float (row, column) pixel coordinates."""
        res = self.res
        rel = np.asarray(pt, dtype=float) - self.position
        depth = -np.dot(rel, self.rz)
        if rel.ndim != 1:
            depth = depth.reshape(-1, 1)
        rel_plane = rel * self.focal_length / depth
        rel_w = np.dot(rel_plane, self.rx)
        rel_h = np.dot(rel_plane, self.ry)
        topleft = np.array([-self.sensor_width / 2,
                            self.sensor_width * (res[1] / res[0]) / 2])
        pix = self.sensor_width / res[0]
        topleft += np.array([pix / 2, -pix / 2])
        return (topleft[1] - rel_h) / pix, (rel_w - topleft[0]) / pix

    def project_depth(self, pt, depth_type: str = "ray"):
        pt = np.asarray(pt, dtype=float)
        if depth_type == "ray":
            return np.linalg.norm(pt - self.position, axis=-1)
        return np.dot(pt - self.position, -self.rz)

    def pack(self):
        return (list(self.res) + [self.sensor_width]
                + self.position.tolist() + self.rx.tolist()
                + self.ry.tolist() + self.rz.tolist() + [self.focal_length])


def backproject_depth_to_ptcloud(
        depth: np.ndarray, camera: Camera, upsample: float = 1.0,
        depth_type: str = "ray") -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """Depth map -> (global points (P, 3), their pixels (rows, columns)).
    Pixels with depth < 0 are background; ``upsample`` resizes the map
    and its mask bilinearly first, keeping only pixels whose whole
    neighbourhood was foreground."""
    mask = (depth >= 0).astype(np.float32)
    if upsample != 1.0:
        h, w = depth.shape
        nh, nw = int(round(h * upsample)), int(round(w * upsample))
        depth = resize_linear(depth.astype(np.float32), nh, nw).astype(
            np.float32)
        mask = resize_linear(mask, nh, nw).astype(np.float32)
        mask = (mask >= 1.0).astype(np.float32)
        depth = np.where(mask > 0, depth, -1.0)
    h, w = depth.shape
    half_w = camera.sensor_width / 2
    half_h = half_w * h / w
    pix = camera.sensor_width / w
    top_left = (camera.position - camera.focal_length * camera.rz
                - half_w * camera.rx + half_h * camera.ry)

    ys, xs = np.where(depth >= 0)
    d = depth[ys, xs][:, None]
    pix_coord = (-(ys + 0.5)[:, None] * pix * camera.ry[None]
                 + (xs + 0.5)[:, None] * pix * camera.rx[None]
                 + top_left[None])
    pix_rel = pix_coord - camera.position[None]
    if depth_type == "plane":
        pts = pix_rel * (d / camera.focal_length) + camera.position[None]
    else:
        pts = (pix_rel / np.linalg.norm(pix_rel, axis=1, keepdims=True)) * d \
            + camera.position[None]
    return pts, (ys, xs)
