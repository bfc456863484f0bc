"""Write the JPEG fixtures of this directory and their references.

Each fixture is made with OpenCV or Pillow from
runs/refscale7k/iter7000_test_image_0.png; beside it, ``<name>.png`` holds
OpenCV's decode of it (``cv2.imread``, RGB) written by the port's
``write_png``.  The fixtures let a machine without OpenCV hold the port's
JPEG decoder to OpenCV's output (``chip_smoke.py``'s "[capture]" phase);
``tests/test_torch_imageio.py`` holds each fixture to its reference.

    python tests/data_torch/jpeg/make_fixtures.py
"""

import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SOURCE = os.path.join(ROOT, "runs", "refscale7k", "iter7000_test_image_0.png")
CROP = (slice(300, 361), slice(500, 597))  # 97x61: odd, not a multiple of 8 or 16

# name -> (writer, crop or None, options)
FIXTURES = {
    # a downsampled capture's image: full size, q95, 4:2:0
    "full_q95_420": ("cv2", None, [cv2.IMWRITE_JPEG_QUALITY, 95,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "crop_444": ("cv2", CROP, [cv2.IMWRITE_JPEG_QUALITY, 90,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "crop_422_restart": ("cv2", CROP, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "crop_grey": ("pil-grey", CROP, dict(quality=90)),
    "crop_exif6": ("pil-exif6", CROP, dict(quality=90)),
}


def write(name, writer, crop, options):
    rgb = cv2.cvtColor(cv2.imread(SOURCE), cv2.COLOR_BGR2RGB)
    if crop is not None:
        rgb = np.ascontiguousarray(rgb[crop])
    path = os.path.join(HERE, f"{name}.jpg")
    if writer == "cv2":
        cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), options)
    elif writer == "pil-grey":
        Image.fromarray(rgb).convert("L").save(path, **options)
    else:
        exif = Image.Exif()
        exif[0x0112] = 6  # rotate 90 degrees clockwise to display
        Image.fromarray(rgb).save(path, exif=exif, **options)
    return path


def main():
    sys.path.insert(0, ROOT)
    from gaussian_splatting_torch.dataio.png import write_png

    for name, (writer, crop, options) in FIXTURES.items():
        path = write(name, writer, crop, options)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        write_png(os.path.join(HERE, f"{name}.png"), ref)
        print(f"{name}: {ref.shape[1]}x{ref.shape[0]}, {os.path.getsize(path)} + "
              f"{os.path.getsize(os.path.join(HERE, name + '.png'))} bytes")


if __name__ == "__main__":
    main()
