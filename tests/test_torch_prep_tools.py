"""The port's data-prep subcommands of `python -m spnerf_torch.tools`
(utm-to-geocentric, convert-tiff, cal-rmse-depth, viz-depth-in, viz-dsm)
and `spnerf_torch.visualization.depth` against `spnerf_tpu.tools.main` and
`spnerf_tpu.visualization`, on an AOI made by `write_raw_aoi` (numpy seed)
and prepared by the port.

Each subcommand runs in both packages on the same inputs: the written files
are byte for byte equal, the printed JSON of cal-rmse-depth within 1e-5 m
(MAE, RMSE; coverage exact; the port's splat on the CPU), and the PNGs
decode to the same pixels. `padded_depth_image` is exact. `main`'s two
argument checks exit as the JAX package's do. With matplotlib hidden the
viz subcommands print one line naming the PNGs they skip and write none.
cal-rmse-depth without CUDA raises unless given --device cpu.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from spnerf_tpu import tools as jtools
from spnerf_tpu.visualization import depth as jdepth
from spnerf_torch import tools
from spnerf_torch.data.create_dataset import create_satellite_dataset
from spnerf_torch.data.synth_depth import synthesize_depth_from_lidar
from spnerf_torch.visualization import depth as tdepth
from spnerf_torch.utils.synth_scene import write_raw_aoi

AOI = "JAX_269"


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    write_raw_aoi(str(root / "raw"), crop_px=48, roi_size=32, seed=6)
    out = create_satellite_dataset(AOI, str(root / "raw"),
                                   str(root / "prepared"), seed=0)[0]
    synthesize_depth_from_lidar(
        os.path.join(out, "JSON"), os.path.join(out, "Truth"), AOI,
        os.path.join(out, "Depth"), stride=2, verbose=False)
    train = open(os.path.join(out, "JSON", "train.txt")).read().split()[0]
    img_id = train[:-len(".json")]
    return {"root": out, "img_id": img_id,
            "pts2d": os.path.join(out, "Depth", f"{img_id}_2DPts.txt"),
            "pts3d": os.path.join(out, "Depth", f"{img_id}_3DPts_ecef.txt"),
            "image": os.path.join(out, "RGB", AOI, f"{img_id}.tif"),
            "dsm": os.path.join(out, "Truth", f"{AOI}_DSM.tif"),
            "gt_dir": os.path.join(out, "Truth")}


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def utm_points(d):
    """A *_3DPts.txt in UTM under d (MicMac's own output)."""
    g = np.random.default_rng(2)
    os.makedirs(d, exist_ok=True)
    pts = np.stack([g.uniform(4.38e5, 4.39e5, 40),
                    g.uniform(3.353e6, 3.354e6, 40), g.uniform(0, 30, 40)], -1)
    for k in range(2):
        np.savetxt(os.path.join(d, f"{AOI}_00{k}_RGB_3DPts.txt"), pts + k)
    return d


@pytest.mark.parametrize("how", [["--file_dir", "{d}", "--aoi_id", AOI],
                                 ["--file", "{d}/JAX_269_001_RGB_3DPts.txt",
                                  "--zone", "15"]])
def test_utm_to_geocentric_matches_jax(how, tmp_path, capsys):
    for pkg, main in (("port", tools.main), ("jax", jtools.main)):
        d = utm_points(str(tmp_path / pkg))
        main(["utm-to-geocentric"] + [a.format(d=d) for a in how])
    out = capsys.readouterr().out
    assert out.count("->") == 2 * (2 if "--file_dir" in how else 1)
    names = sorted(f for f in os.listdir(tmp_path / "jax")
                   if f.endswith("_ecef.txt"))
    assert len(names) == (2 if "--file_dir" in how else 1)
    for name in names:
        assert file_bytes(tmp_path / "port" / name) == file_bytes(
            tmp_path / "jax" / name)


@pytest.mark.parametrize("argv,message", [
    (["utm-to-geocentric", "--file_dir", "x"], "--aoi_id or --zone"),
    (["utm-to-geocentric", "--zone", "17"], "--file_dir or --file"),
    (["utm-to-geocentric", "--file_dir", "/nonexistent", "--zone", "17"],
     "no \\*_3DPts.txt"),
])
def test_utm_to_geocentric_argument_checks(argv, message):
    for main in (tools.main, jtools.main):
        with pytest.raises(SystemExit, match=message):
            main(argv)


def test_convert_tiff_matches_jax(aoi, tmp_path, capsys):
    inputs = [aoi["image"], aoi["dsm"]]
    tools.main(["convert-tiff", *inputs, "--out_dir", str(tmp_path / "port")])
    jtools.main(["convert-tiff", *inputs, "--out_dir", str(tmp_path / "jax")])
    assert capsys.readouterr().out.count("->") == 4
    for p in inputs:
        name = os.path.basename(p)
        assert file_bytes(tmp_path / "port" / name) == file_bytes(
            tmp_path / "jax" / name)
        np.testing.assert_array_equal(
            tdepth.read_tiff(str(tmp_path / "port" / name)),
            tdepth.read_tiff(p))


def test_cal_rmse_depth_matches_jax(aoi, tmp_path, capsys):
    base = ["cal-rmse-depth", "--pts3d_ecef", aoi["pts3d"], "--gt_dir",
            aoi["gt_dir"], "--aoi_id", AOI]
    ours = tools.main(base + ["--out_dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jtools.main(base + ["--out_dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == ours and set(ours) == set(ref)
    for k in ("mae", "rmse"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5)
    assert ours["coverage"] == ref["coverage"]
    name = f"{AOI}_depth_dsm.tif"
    a, _ = tdepth.read_geotiff(str(tmp_path / "port" / name))
    b, _ = tdepth.read_geotiff(str(tmp_path / "jax" / name))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_cal_rmse_depth_needs_the_card_or_cpu(aoi):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.main(["cal-rmse-depth", "--pts3d_ecef", aoi["pts3d"],
                    "--gt_dir", aoi["gt_dir"], "--aoi_id", AOI])


def test_padded_depth_image_is_exact():
    g = np.random.default_rng(3)
    pts = np.stack([g.integers(-3, 25, 200), g.integers(-3, 19, 200)], -1)
    vals = g.normal(size=200)
    ours = tdepth.padded_depth_image((16, 22, 3), pts, vals)
    ref = jdepth.padded_depth_image((16, 22, 3), pts, vals)
    assert ours.shape == (16, 22)
    np.testing.assert_array_equal(ours, ref)


def test_viz_subcommands_draw_the_jax_packages_pixels(aoi, tmp_path):
    for pkg, main in (("port", tools.main), ("jax", jtools.main)):
        d = tmp_path / pkg
        d.mkdir()
        main(["viz-depth-in", "--pts2d", aoi["pts2d"], "--pts3d",
              aoi["pts3d"], "--image", aoi["image"], "--out_prefix",
              str(d / "depth")])
        main(["viz-dsm", aoi["dsm"], str(d / "dsm.png")])
    names = ["depth_raw.png", "depth_overlay.png", "depth_side_by_side.png",
             "dsm.png"]
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(names)
    for name in names:
        a, b = pixels(tmp_path / "port" / name), pixels(tmp_path / "jax" / name)
        assert a.shape == b.shape and a.shape[0] > 100, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_viz_without_matplotlib_names_the_pngs(aoi, tmp_path, monkeypatch,
                                               capsys):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    prefix = str(tmp_path / "depth")
    depth = tools.main(["viz-depth-in", "--pts2d", aoi["pts2d"], "--pts3d",
                        aoi["pts3d"], "--image", aoi["image"],
                        "--out_prefix", prefix])
    assert tools.main(["viz-dsm", aoi["dsm"], str(tmp_path / "dsm.png")]) \
        is None
    tdepth.overlay_depth_on_image(np.zeros((2, 2, 3)), np.zeros((2, 2)),
                                  str(tmp_path / "o.png"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [
        "matplotlib is not installed: " + " and ".join(
            f"{prefix}_{k}.png" for k in ("raw", "overlay", "side_by_side"))
        + " not written",
        f"matplotlib is not installed: {tmp_path / 'dsm.png'} not written",
        f"matplotlib is not installed: {tmp_path / 'o.png'} not written"]
    assert os.listdir(tmp_path) == []
    pts = np.loadtxt(aoi["pts2d"], dtype=np.int64)
    assert np.isfinite(depth).sum() == len(pts)
