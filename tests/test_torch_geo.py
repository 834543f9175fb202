"""The port's geodesy (`spnerf_torch.geo`) against the JAX package's, float64
numpy in both. Being copies of the same numpy code, the results are expected
bitwise equal; the stated limits are 1e-9 degrees and 1e-6 m (1e-6 px in the
image).

* `geodetic_to_ecef` / `ecef_to_latlon`, `latlon_to_utm` / `utm_to_latlon`
  on seeded points across zones and both hemispheres, and `utm_zone` on
  seeded points and the Norway/Svalbard exceptions.
* `RPCModel.projection` / `localization` on the synthetic AOI's rational
  RPC (`spnerf_torch.utils.synth_scene`), `rescaled`, `to_dict` / `from_dict`;
  `localization` inverts `projection` to 1e-6 px.
* The incidence angles and the two image sorts on the synthetic AOI.
"""

import numpy as np
import pytest

from spnerf_tpu import geo as jgeo
from spnerf_tpu.geo import utm as jutm
from spnerf_torch import geo
from spnerf_torch.geo import utm
from spnerf_torch.io import read_dict_from_json
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

DEG, M, PX = 1e-9, 1e-6, 1e-6


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    return write_synthetic_aoi(str(tmp_path_factory.mktemp("aoi")), width=40,
                               height=36, roi_size=24, seed=3)


def points(n=2000, seed=0):
    g = np.random.default_rng(seed)
    return (g.uniform(-79.5, 83.5, n), g.uniform(-179.9, 179.9, n),
            g.uniform(-100.0, 9000.0, n))


def test_ellipsoid_matches_jax():
    lat, lon, alt = points()
    xyz = geo.geodetic_to_ecef(lat, lon, alt)
    ref = jgeo.geodetic_to_ecef(lat, lon, alt)
    for a, b in zip(xyz, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=M)
    back = geo.ecef_to_latlon(*xyz)
    jback = jgeo.ecef_to_latlon(*ref)
    for a, b, tol in zip(back, jback, (DEG, DEG, M)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    np.testing.assert_allclose(back[0], lat, atol=1e-8)
    np.testing.assert_allclose(back[2], alt, atol=1e-3)


@pytest.mark.parametrize("lon0", [-81.66, -3.0, 10.5, 151.2])
@pytest.mark.parametrize("south", [False, True])
def test_utm_matches_jax(lon0, south):
    g = np.random.default_rng(int(lon0 * 10) % 1000 + south)
    lat = g.uniform(0.5, 70.0, 500) * (-1 if south else 1)
    lon = lon0 + g.uniform(-2.9, 2.9, 500)
    e, n, zone, north = geo.latlon_to_utm(lat, lon)
    je, jn, jzone, jnorth = jgeo.latlon_to_utm(lat, lon)
    assert (zone, north) == (jzone, jnorth) and north == (not south)
    np.testing.assert_allclose(e, je, rtol=0, atol=M)
    np.testing.assert_allclose(n, jn, rtol=0, atol=M)
    la, lo = geo.utm_to_latlon(e, n, zone, north)
    jla, jlo = jutm.utm_to_latlon(je, jn, jzone, jnorth)
    np.testing.assert_allclose(la, jla, rtol=0, atol=DEG)
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=DEG)
    np.testing.assert_allclose(la, lat, atol=1e-8)
    assert geo.utm_epsg(zone, north) == jgeo.utm_epsg(jzone, jnorth)


def test_utm_zone_matches_jax():
    lat, lon, _ = points(3000, seed=5)
    lat = np.concatenate([lat, [60.0, 56.0, 63.9, 78.0, 78.0, 78.0, 78.0,
                                84.0, 72.0, -85.0, 85.0, 0.0, -80.0]])
    lon = np.concatenate([lon, [5.0, 3.0, 11.9, 8.9, 9.0, 20.9, 32.9, 41.9,
                                0.0, -179.9, 179.9, 180.0, -180.0]])
    for la, lo in zip(lat, lon):
        assert utm.utm_zone(la, lo) == jgeo.utm_zone(la, lo), (la, lo)
    assert utm.utm_zone(60.0, 5.0) == (32, "V")  # Norway
    assert [utm.utm_zone(78.0, x)[0] for x in (8.9, 9.0, 21.0, 33.0)] == [
        31, 33, 35, 37]  # Svalbard


def rpc_pair(aoi, k=0):
    meta = read_dict_from_json(f"{aoi['json_dir']}/{aoi['train'][k]}.json")
    return (geo.RPCModel.from_dict(meta["rpc"]),
            jgeo.RPCModel.from_dict(meta["rpc"]), meta)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_rpc_projection_and_localization_match_jax(aoi, k):
    rpc, jrpc, meta = rpc_pair(aoi, k)
    g = np.random.default_rng(k)
    cols = g.uniform(-5, meta["width"] + 5, 3000)
    rows = g.uniform(-5, meta["height"] + 5, 3000)
    alts = g.uniform(meta["min_alt"], meta["max_alt"], 3000)
    lon, lat = rpc.localization(cols, rows, alts)
    jlon, jlat = jrpc.localization(cols, rows, alts)
    np.testing.assert_allclose(lon, jlon, rtol=0, atol=DEG)
    np.testing.assert_allclose(lat, jlat, rtol=0, atol=DEG)
    c, r = rpc.projection(lon, lat, alts)
    jc, jr = jrpc.projection(lon, lat, alts)
    np.testing.assert_allclose(c, jc, rtol=0, atol=PX)
    np.testing.assert_allclose(r, jr, rtol=0, atol=PX)
    # localization inverts projection
    np.testing.assert_allclose(c, cols, rtol=0, atol=PX)
    np.testing.assert_allclose(r, rows, rtol=0, atol=PX)


def test_rpc_is_not_affine(aoi):
    """The synthetic camera is rational and leans off-nadir: altitude moves
    the image point, and the denominators are not constant."""
    rpc, _, meta = rpc_pair(aoi)
    assert np.count_nonzero(rpc.col_den[1:]) and np.count_nonzero(
        rpc.row_den[1:])
    lon, lat = rpc.localization(np.array([20.0]), np.array([18.0]),
                                np.array([meta["min_alt"]]))
    c0, r0 = rpc.projection(lon, lat, np.array([meta["min_alt"]]))
    c1, r1 = rpc.projection(lon, lat, np.array([meta["max_alt"]]))
    assert np.hypot(c1 - c0, r1 - r0)[0] > 1.0


def test_rpc_rescaled_and_dict_round_trip(aoi):
    rpc, jrpc, _ = rpc_pair(aoi)
    for alpha in (0.5, 0.25, 1.0 / 3.0):
        ours, ref = rpc.rescaled(alpha), jrpc.rescaled(alpha)
        assert ours.to_dict() == ref.to_dict()
        cols, rows = np.array([0.0, 7.5, 13.0]), np.array([1.0, 9.0, 12.5])
        alts = np.array([0.0, 5.0, -2.0])
        np.testing.assert_allclose(ours.localization(cols, rows, alts),
                                   ref.localization(cols, rows, alts),
                                   rtol=0, atol=DEG)
    assert geo.RPCModel.from_dict(rpc.to_dict()).to_dict() == rpc.to_dict()


def test_incidence_angles_and_sorts_match_jax(aoi):
    rpc, jrpc, meta = rpc_pair(aoi)
    lon_c, lat_c = meta["geojson"]["center"]
    a = geo.view_incidence_angle(rpc, lon_c, lat_c)
    assert a == pytest.approx(jgeo.view_incidence_angle(jrpc, lon_c, lat_c),
                              abs=1e-9)
    assert 4.0 < a < 26.0  # the writer's off-nadir range
    for el, az in ((37.0, 123.0), (90.0, 0.0), (55.5, 181.0)):
        assert geo.solar_incidence_angle(el, az) == pytest.approx(
            jgeo.solar_incidence_angle(el, az), abs=1e-9)
    jd = aoi["json_dir"]
    assert (geo.sort_by_increasing_view_incidence_angle(jd)
            == jgeo.sort_by_increasing_view_incidence_angle(jd))
    assert (geo.sort_by_increasing_solar_incidence_angle(jd)
            == jgeo.sort_by_increasing_solar_incidence_angle(jd))
