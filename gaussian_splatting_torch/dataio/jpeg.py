"""A JPEG decoder of the port's own (``csrc/image_decode.cpp``, built by
``native.py``), for machines without OpenCV or Pillow.

Baseline and extended-sequential Huffman JPEGs of 8-bit samples, grey or
YCbCr with sampling factors up to 2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), with
restart intervals, decoded with libjpeg-turbo's default algorithms (the
ISLOW IDCT, fancy upsampling, its YCbCr tables), which ``cv2.imread``
uses, and the EXIF orientation applied as ``cv2.imread`` applies it.
Progressive, lossless, hierarchical, arithmetic-coded, 12-bit, CMYK and
RGB-coded (Adobe transform 0) files raise a ValueError naming the file
and the feature; so does a truncated or corrupt file.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

SOI = b"\xff\xd8"


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation (1-8) as OpenCV's ``ExifTransform`` does."""
    if orientation >= 5:  # 5-8 transpose first
        img = img.transpose(1, 0, 2)
    flip = {2: "h", 3: "hv", 4: "v", 6: "h", 7: "hv", 8: "v"}.get(orientation, "")
    if "h" in flip:
        img = img[:, ::-1]
    if "v" in flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_jpeg(path) -> np.ndarray:
    """uint8 (H, W, 3) RGB of a JPEG file, oriented by its EXIF tag."""
    from gaussian_splatting_torch.dataio import native

    data = Path(path).read_bytes()
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    lib = native.decoders()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    info = np.zeros(4, np.int32)
    native.check(lib.gs_jpeg_header(buf.ctypes.data, buf.size, info.ctypes.data, err,
                                    len(err)), err, path)
    width, height, _, orientation = (int(x) for x in info)
    out = np.empty((height, width, 3), np.uint8)
    native.check(lib.gs_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, err,
                                    len(err)), err, path)
    return orient(out, orientation)
