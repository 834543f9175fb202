"""Rational Polynomial Coefficient (RPC) camera model, self-contained and vectorized.

The reference SP-NeRF uses the `rpcm` package to project and localize pixels.
This module, as `spnerf_tpu/geo/rpc.py`, implements the model from the RPC
definition itself:

  * the 20-term cubic polynomial uses rpcm's monomial ordering, so coefficients from
    the dataset JSONs (`rpc` dict in "rpcm" format, DFC2019 `JSON/*.json`) are
    consumed as-is;
  * `localization` (image point + altitude -> lon/lat) inverts the projection with a
    damped Gauss-Newton using the *analytic* Jacobian of the rational functions,
    instead of rpcm's finite-difference fixed-point scheme — it converges to
    reprojection error < 1e-9 px in a handful of iterations.

float64 numpy on the host.
"""

from dataclasses import dataclass, replace

import numpy as np

# rpcm monomial ordering for apply_poly(poly, x, y, z):
#   1, y, x, z, yx, yz, xz, y^2, x^2, z^2, xyz, y^3, yx^2, yz^2, y^2x, x^3,
#   xz^2, y^2z, x^2z, z^3
# where, in projection, (x, y, z) = (normalized lat, normalized lon, normalized alt).


def poly20(c, x, y, z):
    """Evaluate the 20-term RPC cubic with rpcm's monomial ordering."""
    return (
        c[0]
        + c[1] * y
        + c[2] * x
        + c[3] * z
        + c[4] * y * x
        + c[5] * y * z
        + c[6] * x * z
        + c[7] * y * y
        + c[8] * x * x
        + c[9] * z * z
        + c[10] * x * y * z
        + c[11] * y * y * y
        + c[12] * y * x * x
        + c[13] * y * z * z
        + c[14] * y * y * x
        + c[15] * x * x * x
        + c[16] * x * z * z
        + c[17] * y * y * z
        + c[18] * x * x * z
        + c[19] * z * z * z
    )


def poly20_grad_xy(c, x, y, z):
    """Partial derivatives (d/dx, d/dy) of :func:`poly20`."""
    dx = (
        c[2]
        + c[4] * y
        + c[6] * z
        + 2.0 * c[8] * x
        + c[10] * y * z
        + 2.0 * c[12] * y * x
        + c[14] * y * y
        + 3.0 * c[15] * x * x
        + c[16] * z * z
        + 2.0 * c[18] * x * z
    )
    dy = (
        c[1]
        + c[4] * x
        + c[5] * z
        + 2.0 * c[7] * y
        + c[10] * x * z
        + 3.0 * c[11] * y * y
        + c[12] * x * x
        + c[13] * z * z
        + 2.0 * c[14] * y * x
        + c[17] * y * z
    )
    return dx, dy


@dataclass(frozen=True)
class RPCModel:
    """RPC model with rpcm-format fields (all floats / length-20 float arrays)."""

    row_offset: float
    col_offset: float
    lat_offset: float
    lon_offset: float
    alt_offset: float
    row_scale: float
    col_scale: float
    lat_scale: float
    lon_scale: float
    alt_scale: float
    row_num: np.ndarray
    row_den: np.ndarray
    col_num: np.ndarray
    col_den: np.ndarray

    @classmethod
    def from_dict(cls, d):
        """Build from the `rpc` dict stored in the dataset JSONs ("rpcm" format)."""
        return cls(
            row_offset=float(d["row_offset"]),
            col_offset=float(d["col_offset"]),
            lat_offset=float(d["lat_offset"]),
            lon_offset=float(d["lon_offset"]),
            alt_offset=float(d["alt_offset"]),
            row_scale=float(d["row_scale"]),
            col_scale=float(d["col_scale"]),
            lat_scale=float(d["lat_scale"]),
            lon_scale=float(d["lon_scale"]),
            alt_scale=float(d["alt_scale"]),
            row_num=np.asarray(d["row_num"], dtype=np.float64),
            row_den=np.asarray(d["row_den"], dtype=np.float64),
            col_num=np.asarray(d["col_num"], dtype=np.float64),
            col_den=np.asarray(d["col_den"], dtype=np.float64),
        )

    def to_dict(self):
        return {
            "row_offset": self.row_offset,
            "col_offset": self.col_offset,
            "lat_offset": self.lat_offset,
            "lon_offset": self.lon_offset,
            "alt_offset": self.alt_offset,
            "row_scale": self.row_scale,
            "col_scale": self.col_scale,
            "lat_scale": self.lat_scale,
            "lon_scale": self.lon_scale,
            "alt_scale": self.alt_scale,
            "row_num": list(map(float, self.row_num)),
            "row_den": list(map(float, self.row_den)),
            "col_num": list(map(float, self.col_num)),
            "col_den": list(map(float, self.col_den)),
        }

    def rescaled(self, alpha):
        """Scaled copy for an image resize by factor alpha (e.g. 0.5 when the image
        is downsampled 2x). Reference semantics: SP-NeRF's `rescale_rpc`
        (`modules/utils.py:59-77`)."""
        return replace(
            self,
            row_scale=self.row_scale * float(alpha),
            col_scale=self.col_scale * float(alpha),
            row_offset=self.row_offset * float(alpha),
            col_offset=self.col_offset * float(alpha),
        )

    # ------------------------------------------------------------------ projection
    def projection(self, lons, lats, alts):
        """(lon, lat, alt) -> (col, row), vectorized."""
        nlon = (np.asarray(lons, dtype=np.float64) - self.lon_offset) / self.lon_scale
        nlat = (np.asarray(lats, dtype=np.float64) - self.lat_offset) / self.lat_scale
        nalt = (np.asarray(alts, dtype=np.float64) - self.alt_offset) / self.alt_scale
        col = poly20(self.col_num, nlat, nlon, nalt) / poly20(
            self.col_den, nlat, nlon, nalt
        )
        row = poly20(self.row_num, nlat, nlon, nalt) / poly20(
            self.row_den, nlat, nlon, nalt
        )
        return col * self.col_scale + self.col_offset, row * self.row_scale + self.row_offset

    # ---------------------------------------------------------------- localization
    def localization(self, cols, rows, alts, max_iters=20, tol=1e-10):
        """(col, row, alt) -> (lon, lat) by Gauss-Newton inversion (float64 numpy).

        Notes: the residual is in *normalized* image units, so `tol=1e-10` means
        ~1e-10 * col_scale pixels of reprojection error.
        """
        tcol = (np.asarray(cols, dtype=np.float64) - self.col_offset) / self.col_scale
        trow = (np.asarray(rows, dtype=np.float64) - self.row_offset) / self.row_scale
        nalt = (np.asarray(alts, dtype=np.float64) - self.alt_offset) / self.alt_scale

        # unknowns: normalized (lat, lon) = (x, y). Start at the RPC center.
        x = np.zeros_like(tcol)
        y = np.zeros_like(tcol)
        for _ in range(max_iters):
            cn = poly20(self.col_num, x, y, nalt)
            cd = poly20(self.col_den, x, y, nalt)
            rn = poly20(self.row_num, x, y, nalt)
            rd = poly20(self.row_den, x, y, nalt)
            f_col = cn / cd - tcol
            f_row = rn / rd - trow
            if np.max(f_col**2 + f_row**2, initial=0.0) < tol**2:
                break
            cn_x, cn_y = poly20_grad_xy(self.col_num, x, y, nalt)
            cd_x, cd_y = poly20_grad_xy(self.col_den, x, y, nalt)
            rn_x, rn_y = poly20_grad_xy(self.row_num, x, y, nalt)
            rd_x, rd_y = poly20_grad_xy(self.row_den, x, y, nalt)
            # d(col)/dx etc. via quotient rule
            j00 = (cn_x * cd - cn * cd_x) / cd**2  # d f_col / d x
            j01 = (cn_y * cd - cn * cd_y) / cd**2  # d f_col / d y
            j10 = (rn_x * rd - rn * rd_x) / rd**2  # d f_row / d x
            j11 = (rn_y * rd - rn * rd_y) / rd**2  # d f_row / d y
            det = j00 * j11 - j01 * j10
            det = np.where(np.abs(det) < 1e-30, 1e-30, det)
            dx = (j11 * f_col - j01 * f_row) / det
            dy = (j00 * f_row - j10 * f_col) / det
            x = x - dx
            y = y - dy

        lats = x * self.lat_scale + self.lat_offset
        lons = y * self.lon_scale + self.lon_offset
        return lons, lats
