"""RPC ray casting and scene normalization.

The ray parameterization of `spnerf_tpu/data/rays.py` (the reference SP-NeRF's
`datasets/satellite_scene.py:21-68,391-425`): each pixel is localized
at the scene's max altitude (near bound, taken as the ray origin) and min altitude
(far bound); the unit direction points from near to far; near distance is 0 and far
is ||far - near||. Rays are stored as 11 columns
[origin(3), direction(3), near, far, sun_direction(3)].

Host-side float64 numpy (metric-grade geodesy), vectorized over all pixels at once —
the reference loops through rpcm's per-batch localization; here the whole image is a
single Gauss-Newton solve (`spnerf_torch.geo.rpc.RPCModel.localization`).
"""

from dataclasses import dataclass

import numpy as np

from ..geo import geodetic_to_ecef


def cast_rays(cols, rows, rpc, min_alt, max_alt):
    """Cast rays for pixel centers (cols, rows) -> (N, 8) float32 array
    [o(3), d(3), near, far] in ECEF meters."""
    cols = np.asarray(cols, np.float64)
    rows = np.asarray(rows, np.float64)
    max_alts = np.full(cols.shape, float(max_alt))
    min_alts = np.full(cols.shape, float(min_alt))

    lons, lats = rpc.localization(cols, rows, max_alts)
    near = np.stack(geodetic_to_ecef(lats, lons, max_alts), axis=-1)
    lons, lats = rpc.localization(cols, rows, min_alts)
    far = np.stack(geodetic_to_ecef(lats, lons, min_alts), axis=-1)

    d = far - near
    dist = np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate(
        [near, d / dist, np.zeros_like(dist), dist], axis=-1
    )
    return rays.astype(np.float32)


def image_grid(width, height):
    """Row-major pixel grid (cols, rows) flattened like numpy C order
    (reference datasets/satellite_scene.py:195-197)."""
    cols, rows = np.meshgrid(np.arange(width), np.arange(height))
    return cols.ravel(), rows.ravel()


def sun_direction(sun_elevation_deg, sun_azimuth_deg):
    """Unit sun direction in the local ENU-ish frame used by the reference
    (datasets/satellite_scene.py:449-473): [sin(az)cos(el), cos(az)cos(el), sin(el)]."""
    el = np.radians(float(sun_elevation_deg))
    az = np.radians(float(sun_azimuth_deg))
    return np.array(
        [np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)],
        dtype=np.float32,
    )


@dataclass(frozen=True)
class SceneNorm:
    """Scene normalization: ECEF center offset + isotropic range.

    Matches `scene.loc` semantics: center = per-axis offsets, range = max of the
    per-axis scales (reference datasets/satellite_scene.py:122-124).

    frame_offset: optional translation added AFTER normalization, used by
    multi-AOI training to place each AOI in a disjoint region of the shared
    field's domain (one field cannot represent two scenes occupying the same
    normalized cube). Single-AOI runs keep the zero offset, which reproduces
    the reference's normalization exactly.
    """

    center: np.ndarray  # (3,) float64
    range: float
    frame_offset: np.ndarray = None  # (3,) float64 or None for zero

    @classmethod
    def from_scene_loc(cls, d):
        center = np.array(
            [float(d["X_offset"]), float(d["Y_offset"]), float(d["Z_offset"])],
            dtype=np.float64,
        )
        rng = max(float(d["X_scale"]), float(d["Y_scale"]), float(d["Z_scale"]))
        return cls(center=center, range=rng)

    @classmethod
    def fit(cls, points):
        """Fit offsets/scales to a point cloud the way `rpc_scaling_params` does
        (reference modules/utils.py:49-56): scale = (max-min)/2, offset = min+scale."""
        points = np.asarray(points, np.float64)
        scales = (points.max(axis=0) - points.min(axis=0)) / 2.0
        offsets = points.min(axis=0) + scales
        return cls(center=offsets, range=float(scales.max())), {
            "X_scale": float(scales[0]), "X_offset": float(offsets[0]),
            "Y_scale": float(scales[1]), "Y_offset": float(offsets[1]),
            "Z_scale": float(scales[2]), "Z_offset": float(offsets[2]),
        }

    def normalize_rays(self, rays):
        """Normalize (N, >=8) rays in place semantics of the reference
        (datasets/satellite_scene.py:415-425): origin centered/scaled, near/far
        scaled. Returns a new float32 array."""
        out = np.array(rays, dtype=np.float64, copy=True)
        out[:, 0:3] = (out[:, 0:3] - self.center) / self.range
        if self.frame_offset is not None:
            out[:, 0:3] = out[:, 0:3] + self.frame_offset
        out[:, 6:8] = out[:, 6:8] / self.range
        return out.astype(np.float32)

    def normalize_points(self, pts):
        out = (np.asarray(pts, np.float64) - self.center) / self.range
        if self.frame_offset is not None:
            out = out + self.frame_offset
        return out.astype(np.float32)

    def denormalize_points(self, pts):
        pts = np.asarray(pts, np.float64)
        if self.frame_offset is not None:
            pts = pts - self.frame_offset
        return pts * self.range + self.center
