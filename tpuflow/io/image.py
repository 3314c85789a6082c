"""Host-side image IO.

Replaces the reference's 4k-line C `iio` reader (reference src/iio.cpp)
with small numpy codecs: PNG (zlib + struct), binary PGM/PPM, and PFM.
Other formats go through `imageio`, imported only when such a file is
met.  IO is cold path: the reference CLIs read images once per run
(src/tvl1flow_main.cpp:177-178), so no native code is warranted here.

Reading returns float64 numpy arrays to mirror
`iio_read_image_double` (reference src/iio.h:83); grayscale conversion
when a solver wants 1 channel matches iio's mean-of-channels fallback.
"""

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel (gray, RGB, gray+alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _ext(path):
    return str(path).lower().rsplit(".", 1)[-1]


def read_image(path, gray=True, dtype=np.float64):
    """Read an image file -> (H, W) if gray else (H, W, C) float array."""
    ext = _ext(path)
    if ext == "pfm":
        arr = read_pfm(path, dtype=dtype)
    elif ext == "png":
        arr = read_png(path).astype(dtype)
    elif ext in ("pgm", "ppm", "pnm"):
        arr = read_pgm(path, dtype=dtype)
    else:
        arr = np.asarray(_imageio().imread(path)).astype(dtype)
    if gray and arr.ndim == 3:
        # iio collapses to gray by averaging channels when a caller asks
        # for 1 channel (reference src/iio.cpp sample conversion)
        arr = arr.mean(axis=2)
    return arr


def write_image(path, arr):
    """Write an (H, W) or (H, W, C) array; values outside uint8/uint16
    are rounded and clipped to [0, 255]."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    ext = _ext(path)
    if ext == "png":
        write_png(path, arr)
    elif ext in ("pgm", "ppm", "pnm"):
        write_pgm(path, arr)
    else:
        _imageio().imwrite(path, arr)


def _imageio():
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(
            "reading or writing this image format needs the 'imageio' "
            "package; PNG, PGM, PPM and PFM need nothing beyond numpy"
        ) from e
    return iio


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, h, stride, bpp):
    """Undo the per-scanline PNG filters (types 0-4) -> (h, stride)
    uint8."""
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:   # Sub: running sum along each byte phase
            cur = np.zeros(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64) % 256
        elif ftype == 2:   # Up
            cur = line + prev
        elif ftype in (3, 4):   # Average / Paeth: byte-sequential
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path):
    """Read a non-interlaced 8- or 16-bit PNG (gray, gray+alpha, RGB,
    RGBA) -> (H, W) or (H, W, C) uint8/uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIG)
    idat = []
    hdr = None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (colour type {ctype}, depth {depth}, "
            f"interlace {interlace}); needs 8/16-bit non-interlaced "
            "gray, gray+alpha, RGB or RGBA")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        arr = rows.view(">u2").astype(np.uint16)
    else:
        arr = rows
    arr = arr.reshape(h, w, ch)
    return arr[:, :, 0] if ch == 1 else arr


def write_png(path, arr):
    """Write an (H, W) or (H, W, C) uint8/uint16 array (C in 1-4) as a
    PNG with no scanline filter."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def write_pgm(path, arr):
    """Write an (H, W) array as binary PGM (P5) or an (H, W, 3) array as
    binary PPM (P6); 8-bit unless the array is uint16."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    magic = b"P6" if arr.ndim == 3 else b"P5"
    h, w = arr.shape[:2]
    maxval = 65535 if arr.dtype == np.uint16 else 255
    with open(path, "wb") as f:
        f.write(magic + f"\n{w} {h}\n{maxval}\n".encode())
        f.write(arr.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def read_pgm(path, dtype=np.float64):
    """Read a binary PGM (P5) -> (H, W) or PPM (P6) -> (H, W, 3) float
    array (8- or 16-bit samples)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM")
    channels = 3 if data[:2] == b"P6" else 1
    # parse header: magic, width, height, maxval (with comment support)
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while data[pos : pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    sample = ">u2" if maxval > 255 else np.uint8
    arr = np.frombuffer(data, dtype=sample, count=w * h * channels,
                        offset=pos)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return arr.reshape(shape).astype(dtype)


def read_pfm(path, dtype=np.float64):
    """Read a PFM (portable float map) -> (H, W) or (H, W, 3) array.

    Layout per the reference's iio PFM path (src/iio.cpp pfm reader):
    'PF' (color) / 'Pf' (gray) header, width height, scale whose sign
    encodes endianness (negative = little-endian), then float32 rows
    stored BOTTOM-UP."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        while dims and dims[0].startswith(b"#"):
            dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        channels = 3 if magic == b"PF" else 1
        data = np.frombuffer(f.read(4 * w * h * channels),
                             dtype=endian + "f4")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return data.reshape(shape)[::-1].astype(dtype)


def write_pfm(path, arr, scale=-1.0):
    """Write a (H, W) or (H, W, 3) float array as little-endian PFM."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        magic = b"Pf"
    elif arr.ndim == 3 and arr.shape[2] == 3:
        magic = b"PF"
    else:
        raise ValueError(f"PFM needs (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale:g}\n".encode())
        f.write(arr[::-1].astype("<f4").tobytes())
