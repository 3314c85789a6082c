"""Flow-file codecs: Middlebury .flo and JUV .uv.

The .uv writer was validated byte-identical against the reference
binary's own output (iio_save_image_as_juv dispatched by filename
suffix, reference src/iio.cpp:3665-3670): running
`/tmp/refbuild/tvl1flow a.png b.png out.uv` and our
`write_juv(read_juv(out.uv))` produce the same 512,255 bytes.  These
tests pin the byte layout so that property survives without needing
the binary at test time."""

import numpy as np
import pytest

from tpuflow.io.flo import (read_flo, read_flow, read_juv, write_flo,
                            write_flow, write_juv)


def _flow(h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w)).astype(np.float32),
            rng.standard_normal((h, w)).astype(np.float32))


def test_flo_roundtrip(tmp_path):
    u, v = _flow()
    p = str(tmp_path / "f.flo")
    write_flo(p, u, v)
    ru, rv = read_flo(p)
    np.testing.assert_array_equal(ru, u)
    np.testing.assert_array_equal(rv, v)


def test_juv_roundtrip_and_layout(tmp_path):
    u, v = _flow()
    p = str(tmp_path / "f.uv")
    write_juv(p, u, v)
    raw = open(p, "rb").read()
    # reference layout (src/iio.cpp:2729-2751): 255-byte header = text
    # + NUL, space-padded; then planar u, then v, as little-endian f32
    h, w = u.shape
    text = f"#UV {{\n dimx {w} dimy {h}\n}}\n".encode() + b"\0"
    assert raw[: len(text)] == text
    assert raw[len(text):255] == b" " * (255 - len(text))
    assert len(raw) == 255 + 2 * h * w * 4
    np.testing.assert_array_equal(
        np.frombuffer(raw[255:255 + h * w * 4], "<f4").reshape(h, w), u)
    ru, rv = read_juv(p)
    np.testing.assert_array_equal(ru, u)
    np.testing.assert_array_equal(rv, v)


def test_write_flow_extension_dispatch(tmp_path):
    """Dispatch parity with iio_save_image_default
    (src/iio.cpp:3655-3675): .uv -> JUV, anything else -> .flo."""
    u, v = _flow()
    p_uv = str(tmp_path / "f.uv")
    p_flo = str(tmp_path / "f.flo")
    write_flow(p_uv, u, v)
    write_flow(p_flo, u, v)
    assert open(p_uv, "rb").read(4) == b"#UV "
    assert open(p_flo, "rb").read(4) == b"PIEH"
    for p in (p_uv, p_flo):
        ru, rv = read_flow(p)
        np.testing.assert_array_equal(ru, u)
        np.testing.assert_array_equal(rv, v)


REF_FIXTURE = "/root/reference/3rdparty/tvl1flow_3/uv.flo"


def test_reference_flo_fixture(tmp_path):
    """End-to-end codec parity against bytes the reference itself wrote.

    `3rdparty/tvl1flow_3/uv.flo` is the one reference-produced binary
    artifact in the upstream repo (256x256 Middlebury flow, PIEH magic,
    524,300 bytes = 12 + 256*256*2*4).  Reading it through `read_flo`
    and re-encoding through `write_flo` must reproduce the file
    byte-exactly."""
    import os

    import pytest

    if not os.path.exists(REF_FIXTURE):
        pytest.skip("reference checkout not mounted")
    raw = open(REF_FIXTURE, "rb").read()
    assert len(raw) == 524300
    assert raw[:4] == b"PIEH"
    u, v = read_flo(REF_FIXTURE)
    assert u.shape == v.shape == (256, 256)
    assert u.dtype == v.dtype == np.float32
    assert np.isfinite(u).all() and np.isfinite(v).all()
    # plausible dense-flow magnitudes, not constants
    mag = np.hypot(u, v)
    assert 0.0 < float(mag.mean()) < 50.0
    assert float(u.std()) > 0 and float(v.std()) > 0
    p = str(tmp_path / "reencode.flo")
    write_flo(p, u, v)
    assert open(p, "rb").read() == raw


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_roundtrip_without_imageio(tmp_path, monkeypatch, kind):
    """PNG goes through the package's own zlib codec: it round-trips
    with imageio made unimportable, and other formats then fail with an
    error that names the missing package."""
    import sys

    from tpuflow.io.image import read_image, read_png, write_image

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    rng = np.random.default_rng(len(kind))
    dtype = np.uint16 if kind == "gray16" else np.uint8
    shape = (23, 31, 3) if kind == "rgb8" else (23, 31)
    arr = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True)
    arr = arr.astype(dtype)
    p = str(tmp_path / "a.png")
    write_image(p, arr)
    back = read_png(p)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(read_image(p, gray=False), arr)
    if arr.ndim == 3:
        np.testing.assert_allclose(read_image(p), arr.mean(axis=2))
    with pytest.raises(ImportError, match="imageio"):
        write_image(str(tmp_path / "a.tif"), arr)


def _filter_rows(rows, ftype, bpp):
    """PNG scanline filter `ftype` (1 Sub, 2 Up, 3 Average, 4 Paeth)
    applied to (h, stride) uint8 rows, straight from the PNG spec."""
    out = []
    prev = [0] * rows.shape[1]
    for row in rows.tolist():
        line = [ftype]
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line.append((x - pred) % 256)
        out.append(bytes(line))
        prev = row
    return b"".join(out)


@pytest.mark.parametrize("kind", ["gray8", "rgb16"])
@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
def test_png_reads_filtered_scanlines(tmp_path, ftype, kind):
    """Encoders filter scanlines (Sub/Up/Average/Paeth); read_png must
    undo each one, for one-byte and multi-byte pixels."""
    import struct
    import zlib

    from tpuflow.io.image import read_png

    rng = np.random.default_rng(ftype)
    if kind == "gray8":
        arr, depth, ctype = rng.integers(0, 256, (9, 13)).astype(np.uint8), 8, 0
        rows, bpp = arr, 1
    else:
        arr = rng.integers(0, 65536, (9, 13, 3)).astype(np.uint16)
        depth, ctype, bpp = 16, 2, 6
        rows = arr.astype(">u2").reshape(9, -1).view(np.uint8)
    h, w = arr.shape[:2]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    raw = _filter_rows(rows, ftype, bpp)
    p = tmp_path / "f.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n"
                  + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                               ctype, 0, 0, 0))
                  + chunk(b"IDAT", zlib.compress(raw))
                  + chunk(b"IEND", b""))
    back = read_png(str(p))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
