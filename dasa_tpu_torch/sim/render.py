"""Cubemap renderer — perspective RGB views from skybox faces.

Replaces the reference's OpenGL/OSMesa renderer (src/lib/MatterSim.cpp:
117-229 GL setup, 441-468 renderScene, vertex/fragment cubemap shaders)
with a pure array computation: build the pixel ray directions for the
requested (heading, elevation, vfov) camera, classify each ray to a cube
face, and bilinearly sample that face — one vectorized gather instead of
a GL pipeline, in numpy on the host.  A copy of
``dasa_tpu/sim/render.py`` with nothing changed but this docstring; the
offline featurizer (``pipelines/depth_features.py``) consumes its views.

World convention matches the simulator: z up, heading from +y turning
right, elevation up positive.  Face order follows the skybox files:
0=up, 1=front(+y), 2=right(+x), 3=back(-y), 4=left(-x), 5=down
(MatterSim.cpp:322-328 maps files to GL cube faces; our sampler uses
the same assignment).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

FACE_UP, FACE_FRONT, FACE_RIGHT, FACE_BACK, FACE_LEFT, FACE_DOWN = range(6)


def camera_rays(width: int, height: int, heading: float,
                elevation: float, vfov: float) -> np.ndarray:
    """(H, W, 3) unit ray directions in world coordinates."""
    hfov = vfov * width / height
    # camera basis: forward f, right r, up u
    ch, sh = math.cos(heading), math.sin(heading)
    ce, se = math.cos(elevation), math.sin(elevation)
    f = np.array([sh * ce, ch * ce, se])
    r = np.array([ch, -sh, 0.0])
    u = np.cross(r, f)
    xs = np.linspace(-math.tan(hfov / 2), math.tan(hfov / 2), width)
    ys = np.linspace(math.tan(vfov / 2), -math.tan(vfov / 2), height)
    xg, yg = np.meshgrid(xs, ys)
    rays = (f[None, None] + xg[..., None] * r[None, None]
            + yg[..., None] * u[None, None])
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def _face_uv(rays: np.ndarray):
    """Classify rays to faces and compute in-face (u, v) in [0, 1].

    Faces in world coords: front=+y, right=+x, back=-y, left=-x,
    up=+z, down=-z.  (u, v) are oriented so that v grows downward in
    the image and u grows rightward when looking at the face from the
    cube center.
    """
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)

    face = np.zeros(x.shape, np.int32)
    u = np.zeros_like(x)
    v = np.zeros_like(x)

    # +y (front): u ~ +x, v ~ -z
    m = (ay >= ax) & (ay >= az) & (y > 0)
    face[m] = FACE_FRONT
    u[m] = x[m] / ay[m]
    v[m] = -z[m] / ay[m]
    # -y (back): u ~ -x
    m = (ay >= ax) & (ay >= az) & (y <= 0)
    face[m] = FACE_BACK
    u[m] = -x[m] / ay[m]
    v[m] = -z[m] / ay[m]
    # +x (right): u ~ -y
    m = (ax > ay) & (ax >= az) & (x > 0)
    face[m] = FACE_RIGHT
    u[m] = -y[m] / ax[m]
    v[m] = -z[m] / ax[m]
    # -x (left): u ~ +y
    m = (ax > ay) & (ax >= az) & (x <= 0)
    face[m] = FACE_LEFT
    u[m] = y[m] / ax[m]
    v[m] = -z[m] / ax[m]
    # +z (up): v ~ +y (looking up, forward appears at image bottom)
    m = (az > ax) & (az > ay) & (z > 0)
    face[m] = FACE_UP
    u[m] = x[m] / az[m]
    v[m] = y[m] / az[m]
    # -z (down): v ~ -y
    m = (az > ax) & (az > ay) & (z <= 0)
    face[m] = FACE_DOWN
    u[m] = x[m] / az[m]
    v[m] = -y[m] / az[m]

    return face, (u + 1) / 2, (v + 1) / 2


def render_view(faces: Sequence[np.ndarray], heading: float,
                elevation: float, width: int = 640, height: int = 480,
                vfov: float = math.radians(60)) -> np.ndarray:
    """Render an (H, W, C) perspective view from 6 (S, S, C) cube faces
    via bilinear sampling."""
    faces = np.stack(faces)  # (6, S, S, C)
    size = faces.shape[1]
    rays = camera_rays(width, height, heading, elevation, vfov)
    face, u, v = _face_uv(rays)
    fx = u * (size - 1)
    fy = v * (size - 1)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, size - 1)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, size - 1)
    x1 = np.clip(x0 + 1, 0, size - 1)
    y1 = np.clip(y0 + 1, 0, size - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    out = (faces[face, y0, x0] * (1 - wx) * (1 - wy)
           + faces[face, y0, x1] * wx * (1 - wy)
           + faces[face, y1, x0] * (1 - wx) * wy
           + faces[face, y1, x1] * wx * wy)
    return out


def load_render_spec(path: str):
    """Parse the reference's golden-render spec
    (src/test/rendertest_spec.json, consumed by the RGB Image test at
    src/test/main.cpp:302-338): a list of camera poses, each paired
    with a WebGL reference render filename."""
    import json

    with open(path) as f:
        cases = json.load(f)
    out = []
    for c in cases:
        out.append({
            "scan": str(c["scanId"]),
            "viewpoint": str(c["viewpointId"]),
            "heading": float(c["heading"]),
            "elevation": float(c["elevation"]),
            "reference_image": str(c["reference_image"]),
        })
    return out


def render_regression(spec, faces_for, golden_dir: str,
                      out_dir: str = None, width: int = 640,
                      height: int = 480,
                      vfov: float = math.radians(60),
                      tolerance: float = 0.15):
    """The reference's golden-image regression (src/test/main.cpp:
    302-338): render each spec pose and compare against the WebGL
    golden with per-pixel-normalized L2 error < tolerance.

    `faces_for(scan, viewpoint) -> 6 x (S, S, 3) uint8 faces` supplies
    the skybox textures (real Matterport skyboxes when mounted, or
    synthetic cubemaps in tests).  Returns one record per case with
    the error and pass flag; raises nothing — the caller asserts.
    Renders are optionally saved to out_dir for inspection (the
    reference's sim_imgs/)."""
    import os

    from PIL import Image

    results = []
    for case in spec:
        faces = faces_for(case["scan"], case["viewpoint"])
        img = render_view(faces, case["heading"], case["elevation"],
                          width, height, vfov)
        img8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            Image.fromarray(img8).save(
                os.path.join(out_dir, case["reference_image"]))
        gpath = os.path.join(golden_dir, case["reference_image"])
        golden = np.asarray(Image.open(gpath).convert("RGB"))
        # cv::norm(a, b, CV_L2) / (rows * cols)  (main.cpp:333-334)
        diff = golden.astype(np.float64) - img8.astype(np.float64)
        err = float(np.sqrt((diff ** 2).sum()) / (height * width))
        results.append({**case, "error": err,
                        "passed": err < tolerance})
    return results


def render_panorama(faces: Sequence[np.ndarray], width: int = 640,
                    height: int = 480,
                    vfov: float = math.radians(60)) -> np.ndarray:
    """All 36 discretized views (12 headings x 3 elevations), the view
    grid the featurizers consume."""
    out = []
    for elev_step in (-1, 0, 1):
        for h in range(12):
            out.append(render_view(
                faces, h * math.pi / 6, elev_step * math.pi / 6,
                width, height, vfov))
    return np.stack(out)
