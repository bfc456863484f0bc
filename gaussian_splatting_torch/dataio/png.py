"""PNG on zlib alone, so the port reads and writes images with no image
package: ``write_png`` writes 8-bit grey or RGB; ``read_png`` decodes
what ``cv2.imread(path)`` decodes, as the same uint8 RGB array.

``read_png`` parses the chunks and inflates ``IDAT`` here; the row
unfiltering runs in C++ (``csrc/image_decode.cpp``, built by
``native.py``), since Average and Paeth depend on the pixel to the left.
It reads bit depths 1-16 of colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA) as OpenCV does: grey is replicated to three
channels, alpha and ``tRNS`` are dropped, 16-bit samples keep their high
byte, and grey below 8 bits is scaled to 0-255.  Adam7-interlaced files
raise.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}


def write_png(path, img):
    """Write an (H, W) or (H, W, 3) uint8 array as an 8-bit PNG, every row
    with the Up filter (the difference from the row above) at zlib level 1:
    for a rendered 1297x840 view, less than half the file of unfiltered
    rows at level 6, in half the time."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    colour = 2 if img.ndim == 3 else 0  # truecolour or greyscale
    rows = img.reshape(h, -1)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, rows.shape[1]), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1).tobytes()

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


def _chunks(data: bytes, path):
    """(kind, body) of every chunk up to IEND."""
    off = len(SIGNATURE)
    while True:
        if off + 8 > len(data):
            raise ValueError(f"{path}: PNG ends before IEND (truncated file)")
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        if len(body) != n or off + 12 + n > len(data):
            raise ValueError(f"{path}: PNG chunk {kind!r} runs past the end (truncated file)")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + n


def read_png(path) -> np.ndarray:
    """uint8 (H, W, 3) RGB of a PNG file, equal to
    ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``."""
    from gaussian_splatting_torch.dataio import native

    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour not in COLOUR_TYPES or depth not in COLOUR_TYPES[colour][1]:
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is invalid")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt IDAT stream ({e})") from None
    channels = COLOUR_TYPES[colour][0]
    row_bytes = (w * channels * depth + 7) // 8
    if len(raw) < h * (row_bytes + 1):
        raise ValueError(f"{path}: IDAT holds {len(raw)} bytes, {h * (row_bytes + 1)} "
                         "needed (truncated file)")
    raw = np.frombuffer(raw, np.uint8)
    rows = np.empty((h, row_bytes), np.uint8)
    err = ctypes.create_string_buffer(256)
    native.check(native.decoders().gs_png_unfilter(
        raw.ctypes.data, h, row_bytes, max(1, channels * depth // 8), rows.ctypes.data,
        err, len(err)), err, path)

    if depth == 16:
        samples = rows.reshape(h, w * channels, 2)[..., 0]  # libpng's strip_16
    elif depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        samples = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)
    else:
        samples = rows
    samples = samples.reshape(h, w, channels)
    if colour == 3:
        idx = samples[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the {len(palette)}-colour PLTE")
        return palette[idx]
    if colour in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])
