"""Depth-to-skybox construction (offline pipeline).

Re-derivation of the reference's enable_depth.py pipeline
(scripts/enable_depth.py:47-244): per panorama, the 18 undistorted
z-depth images (3 cameras x 6 yaw angles) are converted to euclidean
ray distances and reprojected onto the 6 skybox cube faces via the
planar homography H = K_face . R_world_to_face . R_cam_to_world .
K_cam^-1, then downsized; holes are filled with an iterative
neighbor-mean dilation (stand-in for the reference's joint bilateral
`cbf` binding, enable_depth.py:104-124).

A copy of ``dasa_tpu/pipelines/enable_depth.py``.  No OpenCV
dependency: warping is a vectorized inverse-map gather in numpy.  File IO stays with the caller — this module operates on arrays
so it is testable without the Matterport dataset.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def intrinsic_matrix(width: int, height: int) -> np.ndarray:
    """Ideal 90-degree-FOV pinhole intrinsics for a cube face."""
    k = np.zeros((3, 3), np.float64)
    k[0, 0] = width / 2.0
    k[1, 1] = height / 2.0
    k[0, 2] = width / 2.0
    k[1, 2] = height / 2.0
    k[2, 2] = 1.0
    return k


def z_to_euclid(k_inv: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Convert a z-buffer depth image to euclidean distance from the
    camera center: divide by cos(angle between each pixel ray and the
    optical axis)."""
    h, w = depth.shape
    y, x = np.indices((h, w))
    pix = np.stack([x.ravel(), y.ravel(), np.ones(x.size)], axis=0)
    rays = k_inv @ pix
    cos_theta = rays[2] / np.linalg.norm(rays, axis=0)
    return depth / cos_theta.reshape(h, w)


# Cube-face orientations relative to the reference camera frame
# (z forward, x right, y down).  Order: front, right, back, left, up,
# down — callers map dataset-specific face indices onto these.
CUBE_FACE_ROTATIONS = [
    np.eye(3),
    np.array([[0., 0., 1.], [0., 1., 0.], [-1., 0., 0.]]),   # right
    np.array([[-1., 0., 0.], [0., 1., 0.], [0., 0., -1.]]),  # back
    np.array([[0., 0., -1.], [0., 1., 0.], [1., 0., 0.]]),   # left
    np.array([[1., 0., 0.], [0., 0., -1.], [0., 1., 0.]]),   # up
    np.array([[1., 0., 0.], [0., 0., 1.], [0., -1., 0.]]),   # down
]


def warp_homography(image: np.ndarray, h_mat: np.ndarray,
                    out_shape: Tuple[int, int],
                    nearest: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse-map warp: out[p] = image[H^-1 p].  Returns (warped, valid
    mask).  Nearest-neighbor by default (depth must not blend across
    discontinuities)."""
    oh, ow = out_shape
    y, x = np.indices((oh, ow))
    pix = np.stack([x.ravel(), y.ravel(), np.ones(x.size)], axis=0)
    src = np.linalg.inv(h_mat) @ pix
    behind = src[2] <= 1e-9
    zs = np.where(behind, 1.0, src[2])
    sx = src[0] / zs
    sy = src[1] / zs
    ih, iw = image.shape[:2]
    valid = (~behind & (sx >= 0) & (sx <= iw - 1)
             & (sy >= 0) & (sy <= ih - 1))
    if nearest:
        xi = np.clip(np.round(sx).astype(np.int64), 0, iw - 1)
        yi = np.clip(np.round(sy).astype(np.int64), 0, ih - 1)
        out = image[yi, xi]
    else:
        x0 = np.clip(np.floor(sx).astype(np.int64), 0, iw - 1)
        y0 = np.clip(np.floor(sy).astype(np.int64), 0, ih - 1)
        x1 = np.clip(x0 + 1, 0, iw - 1)
        y1 = np.clip(y0 + 1, 0, ih - 1)
        fx = np.clip(sx - x0, 0, 1)
        fy = np.clip(sy - y0, 0, 1)
        out = (image[y0, x0] * (1 - fx) * (1 - fy)
               + image[y0, x1] * fx * (1 - fy)
               + image[y1, x0] * (1 - fx) * fy
               + image[y1, x1] * fx * fy)
    out = np.where(valid, out, 0)
    return out.reshape(oh, ow), valid.reshape(oh, ow)


def fill_holes(depth: np.ndarray, iterations: int = 16) -> np.ndarray:
    """Iterative neighbor-mean dilation into zero-valued holes."""
    d = depth.astype(np.float64)
    for _ in range(iterations):
        holes = d == 0
        if not holes.any():
            break
        padded = np.pad(d, 1)
        neigh = np.stack([
            padded[:-2, 1:-1], padded[2:, 1:-1],
            padded[1:-1, :-2], padded[1:-1, 2:],
        ])
        cnt = (neigh > 0).sum(0)
        mean = neigh.sum(0) / np.maximum(cnt, 1)
        d = np.where(holes & (cnt > 0), mean, d)
    return d.astype(depth.dtype)


def depth_to_skybox_faces(
    depth_images: Dict[str, np.ndarray],
    intrinsics: Dict[str, np.ndarray],
    cam_to_world: Dict[str, np.ndarray],
    skybox_base_rotation: np.ndarray,
    face_size: int = 1024,
    out_size: int = 512,
    do_fill: bool = True,
) -> List[np.ndarray]:
    """Reproject per-camera euclidean depth images onto 6 cube faces.

    depth_images / intrinsics / cam_to_world are keyed by camera-image
    name; `skybox_base_rotation` is the world rotation of the skybox
    reference camera.  Returns 6 (out_size, out_size) depth faces.
    """
    k_face = intrinsic_matrix(face_size, face_size)
    faces = []
    z = np.array([0.0, 0.0, 1.0])
    for face_rot in CUBE_FACE_ROTATIONS:
        face_ctw = skybox_base_rotation @ face_rot
        face_wtc = face_ctw.T
        acc = np.zeros((face_size, face_size), np.float64)
        for name, depth in depth_images.items():
            k_im = intrinsics[name]
            r_ctw = cam_to_world[name][:3, :3]
            # skip cameras facing away from this face
            if (r_ctw @ z) @ (face_ctw @ z) < 0:
                continue
            h_mat = k_face @ face_wtc @ r_ctw @ np.linalg.inv(k_im)
            warped, valid = warp_homography(depth, h_mat,
                                            (face_size, face_size))
            write = valid & (warped > 0)
            acc[write] = warped[write]
        # downsize (nearest) to the simulator's skybox resolution
        step = face_size // out_size
        small = acc[::step, ::step]
        if do_fill:
            small = fill_holes(small)
        faces.append(small)
    return faces
