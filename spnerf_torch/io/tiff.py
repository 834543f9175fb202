"""GeoTIFF I/O without GDAL or rasterio (`spnerf_tpu/io/tiff.py`).

* Reading: a small classic-TIFF parser decodes uncompressed, chunky rasters
  (what `write_geotiff` writes) itself, so reading the port's own files
  needs no PIL; compressed or planar rasters (the DFC2019 originals) go
  through PIL, imported on first use. The geo metadata comes from the TIFF
  tags either way.
* Writing: a self-contained writer (one strip, uncompressed, chunky,
  little-endian) that emits the GeoTIFF tags GDAL needs to georeference
  the file: ModelPixelScale, ModelTiepoint, GeoKeyDirectory (a projected
  CRS as an EPSG code) and the GDAL_NODATA ASCII tag. Its files are byte
  for byte those of the JAX package's writer.

A "profile" is a plain dict with keys: width, height, count, dtype, nodata,
transform (xoff, xres, yoff, yres with yres < 0 for north-up), epsg.
"""

import os
import struct

import numpy as np

# TIFF tag ids
_T_WIDTH = 256
_T_HEIGHT = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SAMPLES = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_BYTES = 279
_T_PLANAR = 284
_T_SAMPLE_FORMAT = 339
_T_PIXEL_SCALE = 33550
_T_TIEPOINT = 33922
_T_GEO_KEYS = 34735
_T_GDAL_NODATA = 42113

# GeoTIFF keys
_GK_MODEL_TYPE = 1024  # 1 = projected, 2 = geographic
_GK_RASTER_TYPE = 1025  # 1 = PixelIsArea
_GK_PROJECTED_CRS = 3072  # EPSG code

_SAMPLE_FORMAT = {  # numpy dtype -> (tiff sample format, bits)
    np.dtype(np.uint8): (1, 8),
    np.dtype(np.uint16): (1, 16),
    np.dtype(np.int16): (2, 16),
    np.dtype(np.int32): (2, 32),
    np.dtype(np.float32): (3, 32),
    np.dtype(np.float64): (3, 64),
}


_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_ifd_raw(path):
    """Minimal classic-TIFF IFD parser (little/big endian, first IFD only).
    Returns ({tag: tuple_of_values}, file bytes, byte order)."""
    with open(path, "rb") as f:
        data = f.read()
    bo = {b"II": "<", b"MM": ">"}[data[:2]]
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic != 42:
        raise ValueError(f"not a classic TIFF: {path}")
    (ifd_off,) = struct.unpack(bo + "I", data[4:8])
    (n,) = struct.unpack(bo + "H", data[ifd_off: ifd_off + 2])
    tags = {}
    for i in range(n):
        e = ifd_off + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e: e + 8])
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            raw = data[e + 8: e + 8 + size]
        else:
            (off,) = struct.unpack(bo + "I", data[e + 8: e + 12])
            raw = data[off: off + size]
        if typ == 2:
            tags[tag] = raw.rstrip(b"\x00")
        elif typ in (5, 10):  # rationals -> floats
            fmt = bo + ("II" if typ == 5 else "ii") * count
            vals = struct.unpack(fmt, raw)
            tags[tag] = tuple(vals[2 * k] / (vals[2 * k + 1] or 1)
                              for k in range(count))
        elif typ in _TYPE_FMT:
            tags[tag] = struct.unpack(bo + _TYPE_FMT[typ] * count, raw)
        else:
            tags[tag] = raw
    return tags, data, bo


def _raw_decodable(tags):
    """An uncompressed, chunky, stripped raster: what `_decode_raw` reads."""
    return (tags.get(_T_COMPRESSION, (1,))[0] == 1
            and (tags.get(_T_PLANAR, (1,))[0] == 1
                 or tags.get(_T_SAMPLES, (1,))[0] == 1)
            and _T_STRIP_OFFSETS in tags)


def _decode_raw(tags, data, bo):
    """Decode an uncompressed chunky-planar TIFF from its tags and bytes."""
    w = tags[_T_WIDTH][0]
    h = tags[_T_HEIGHT][0]
    spp = tags.get(_T_SAMPLES, (1,))[0]
    bits = tags[_T_BITS][0]
    fmt = tags.get(_T_SAMPLE_FORMAT, (1,))[0]
    dtype = {
        (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
        (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
        (3, 32): np.float32, (3, 64): np.float64,
    }[(fmt, bits)]
    dtype = np.dtype(dtype).newbyteorder(bo)
    offsets = tags[_T_STRIP_OFFSETS]
    counts = tags[_T_STRIP_BYTES]
    raw = b"".join(data[o: o + c] for o, c in zip(offsets, counts))
    arr = np.frombuffer(raw, dtype=dtype, count=h * w * spp)
    arr = arr.reshape(h, w, spp) if spp > 1 else arr.reshape(h, w)
    return np.ascontiguousarray(arr.astype(dtype.newbyteorder("=")))


def _read(path):
    """(array, tags) of a TIFF: decoded here when it is uncompressed and
    chunky, else by PIL (the tags then PIL's)."""
    tags, data, bo = _read_ifd_raw(path)
    if _raw_decodable(tags):
        return _decode_raw(tags, data, bo), tags
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im), getattr(im, "tag_v2", None)


def read_tiff(path):
    """Read a (possibly compressed) TIFF into (H, W) or (H, W, C) numpy array."""
    return _read(path)[0]


def _geo_profile_from_tags(tags, arr):
    profile = {
        "width": arr.shape[1],
        "height": arr.shape[0],
        "count": 1 if arr.ndim == 2 else arr.shape[2],
        "dtype": arr.dtype,
        "nodata": None,
        "transform": None,
        "epsg": None,
    }
    if tags is None:
        return profile
    scale = tags.get(_T_PIXEL_SCALE)
    tie = tags.get(_T_TIEPOINT)
    if scale is not None and tie is not None and len(tie) >= 6:
        sx, sy = float(scale[0]), float(scale[1])
        # tiepoint: raster (i, j, k) -> model (x, y, z); standard case i=j=0
        i, j, _, x, y, _ = (float(v) for v in tie[:6])
        xoff = x - i * sx
        yoff = y + j * sy
        profile["transform"] = (xoff, sx, yoff, -sy)
    nod = tags.get(_T_GDAL_NODATA)
    if nod is not None:
        try:
            txt = nod.decode() if isinstance(nod, bytes) else str(nod)
            profile["nodata"] = float(txt.strip().strip("\x00"))
        except ValueError:
            pass
    keys = tags.get(_T_GEO_KEYS)
    if keys is not None:
        keys = list(keys)
        for k in range(4, len(keys), 4):
            key_id, loc, cnt, val = keys[k : k + 4]
            if key_id == _GK_PROJECTED_CRS and loc == 0:
                profile["epsg"] = int(val)
    return profile


def read_geotiff(path):
    """Read a GeoTIFF -> (array, profile dict). See module docstring for profile."""
    arr, tags = _read(path)
    return arr, _geo_profile_from_tags(tags, arr)


def _pack_entries(entries):
    """entries: list of (tag, type_id, count, packed_payload_bytes_or_inline_value)."""
    return sorted(entries, key=lambda e: e[0])


def write_geotiff(path, array, transform=None, epsg=None, nodata=None,
                  profile=None, extra_double_tags=None, extra_ascii_tags=None):
    """Write `array` (H, W) or (H, W, C) as an uncompressed little-endian GeoTIFF.

    transform: (xoff, xres, yoff, yres) with yres negative for north-up rasters,
      so that model_x = xoff + col * xres, model_y = yoff + row * yres
      (the convention of `affine.Affine(res, 0, xoff, 0, -res, yoff)`).
    profile: optional dict supplying transform / epsg / nodata defaults.
    """
    if profile is not None:
        transform = transform if transform is not None else profile.get("transform")
        epsg = epsg if epsg is not None else profile.get("epsg")
        nodata = nodata if nodata is not None else profile.get("nodata")

    arr = np.ascontiguousarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    if arr.dtype not in _SAMPLE_FORMAT:
        raise ValueError(f"unsupported dtype for TIFF write: {arr.dtype}")
    sample_fmt, bits = _SAMPLE_FORMAT[arr.dtype]
    data = arr.astype(arr.dtype.newbyteorder("<")).tobytes()

    # ---- build IFD entries. TIFF types: 2=ascii, 3=short, 4=long, 12=double
    entries = []  # (tag, type, count, inline_value or payload bytes)
    payloads = []  # (tag, bytes) for out-of-line payloads

    def add_short(tag, values):
        values = [int(v) for v in np.atleast_1d(values)]
        if len(values) <= 2:
            inline = 0
            for k, v in enumerate(values):
                inline |= v << (16 * k)
            entries.append((tag, 3, len(values), inline))
        else:
            payloads.append((tag, struct.pack(f"<{len(values)}H", *values)))
            entries.append((tag, 3, len(values), None))

    def add_long(tag, values):
        values = [int(v) for v in np.atleast_1d(values)]
        if len(values) == 1:
            entries.append((tag, 4, 1, values[0]))
        else:
            payloads.append((tag, struct.pack(f"<{len(values)}I", *values)))
            entries.append((tag, 4, len(values), None))

    def add_double(tag, values):
        values = [float(v) for v in np.atleast_1d(values)]
        payloads.append((tag, struct.pack(f"<{len(values)}d", *values)))
        entries.append((tag, 12, len(values), None))

    def add_ascii(tag, text):
        raw = text.encode() + b"\x00"
        if len(raw) <= 4:
            inline = int.from_bytes(raw.ljust(4, b"\x00"), "little")
            entries.append((tag, 2, len(raw), inline))
        else:
            payloads.append((tag, raw))
            entries.append((tag, 2, len(raw), None))

    add_long(_T_WIDTH, w)
    add_long(_T_HEIGHT, h)
    add_short(_T_BITS, [bits] * c)
    add_short(_T_COMPRESSION, 1)
    add_short(_T_PHOTOMETRIC, 2 if (c == 3 and arr.dtype == np.uint8) else 1)
    add_short(_T_SAMPLES, c)
    add_long(_T_ROWS_PER_STRIP, h)
    add_short(_T_PLANAR, 1)
    add_short(_T_SAMPLE_FORMAT, [sample_fmt] * c)
    if transform is not None:
        xoff, xres, yoff, yres = (float(v) for v in transform)
        add_double(_T_PIXEL_SCALE, [abs(xres), abs(yres), 0.0])
        add_double(_T_TIEPOINT, [0.0, 0.0, 0.0, xoff, yoff, 0.0])
    if epsg is not None:
        add_short(
            _T_GEO_KEYS,
            [1, 1, 0, 3]
            + [_GK_MODEL_TYPE, 0, 1, 1]
            + [_GK_RASTER_TYPE, 0, 1, 1]
            + [_GK_PROJECTED_CRS, 0, 1, int(epsg)],
        )
    if nodata is not None:
        nd = float(nodata)
        add_ascii(_T_GDAL_NODATA, "nan" if np.isnan(nd) else repr(nd))
    if extra_double_tags:
        # e.g. the RPC00B coefficient block (tag 50844) for satellite imagery
        for tag, values in extra_double_tags.items():
            add_double(int(tag), np.asarray(values, np.float64))
    if extra_ascii_tags:
        # e.g. the GDAL metadata XML block (tag 42112) carrying NITF_* items
        for tag, text in extra_ascii_tags.items():
            add_ascii(int(tag), str(text))

    # strip offsets / byte counts appended last (offset filled after layout)
    add_long(_T_STRIP_BYTES, len(data))
    entries.append((_T_STRIP_OFFSETS, 4, 1, 0))

    entries = _pack_entries(entries)
    n = len(entries)
    ifd_offset = 8
    ifd_size = 2 + n * 12 + 4
    payload_offset = ifd_offset + ifd_size

    # lay out payloads
    payload_pos = {}
    pos = payload_offset
    blob = b""
    for tag, raw in payloads:
        if len(raw) % 2:
            raw += b"\x00"
        payload_pos[tag] = pos
        blob += raw
        pos += len(raw)
    data_offset = pos

    out = struct.pack("<2sHI", b"II", 42, ifd_offset)
    out += struct.pack("<H", n)
    type_sizes = {2: 1, 3: 2, 4: 4, 12: 8}
    for tag, typ, count, inline in entries:
        if tag == _T_STRIP_OFFSETS:
            value = data_offset
        elif inline is None:
            value = payload_pos[tag]
        elif typ in (3, 4) and count * type_sizes[typ] <= 4:
            value = inline
        else:
            value = inline
        out += struct.pack("<HHII", tag, typ, count, value)
    out += struct.pack("<I", 0)  # next IFD
    out += blob
    out += data

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)
