"""The port's image decoders against OpenCV on the CPU: ``png.read_png``
(bitwise, every colour type and bit depth OpenCV and Pillow write, all five
row filters), ``jpeg.read_jpeg`` (baseline JPEGs that OpenCV and Pillow
write, at the tolerance below), the refusals, the committed JPEG fixtures
of ``tests/data_torch/jpeg/``, and ``dataset.read_rgb``'s choice of
decoder with OpenCV and Pillow hidden."""

import ctypes
import os
import re
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch.dataio import dataset as tds
from gaussian_splatting_torch.dataio import native
from gaussian_splatting_torch.dataio.jpeg import read_jpeg
from gaussian_splatting_torch.dataio.png import read_png, write_png
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "runs", "refscale7k", "iter7000_test_image_0.png")
FIXTURES = os.path.join(ROOT, "tests", "data_torch", "jpeg")
# read_jpeg against cv2.imread: bitwise, tighter than the 2 levels at most
# and mean 0.1 that a decoder differing from libjpeg-turbo's arithmetic in
# its rounding would need; this one follows that arithmetic exactly
JPEG_MAX_DIFF = 0
JPEG_MEAN_DIFF = 0.0
# (height, width): 1x1, odd sizes, and a 1295x839 crop of a rendered view
SIZES = [(1, 1), (9, 17), (61, 97), (839, 1295)]


@pytest.fixture(scope="module")
def source():
    return cv2.cvtColor(cv2.imread(SOURCE), cv2.COLOR_BGR2RGB)


def _crop(img, hw):
    """The (h, w) crop at the centre of ``img``."""
    h, w = hw
    y, x = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
    return np.ascontiguousarray(img[y:y + h, x:x + w])


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


# -------------------------------------------------------------------- PNG

def _write_png_case(kind, img, path):
    """One PNG of ``kind`` made from the RGB crop ``img``."""
    rng = np.random.default_rng(img.size)
    if kind == "rgb8":
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    elif kind == "grey8":
        cv2.imwrite(path, img[..., 1])
    elif kind == "rgba8":
        alpha = rng.integers(0, 256, img.shape[:2] + (1,), dtype=np.uint8)
        Image.fromarray(np.concatenate([img, alpha], 2), "RGBA").save(path)
    elif kind == "palette_trns":
        # 40 colours: an 8-bit palette, with colour 3 transparent
        pal = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE, colors=40)
        pal.save(path, transparency=3)
    elif kind == "rgb16":
        noise = rng.integers(0, 257, img.shape, dtype=np.uint16)
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR).astype(np.uint16) * 256 + noise)
    elif kind == "grey16":
        noise = rng.integers(0, 257, img.shape[:2], dtype=np.uint16)
        cv2.imwrite(path, img[..., 0].astype(np.uint16) * 256 + noise)
    else:
        raise ValueError(kind)


PNG_KINDS = ["rgb8", "grey8", "rgba8", "palette_trns", "rgb16", "grey16"]


def png_filters(path):
    """(bit depth, colour type, the filter byte of every row) of a PNG."""
    data = open(path, "rb").read()
    off, idat = 8, b""
    while True:
        (n,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack_from(">IIBB", data, off + 8)
        elif kind == b"IDAT":
            idat += data[off + 8:off + 8 + n]
        elif kind == b"IEND":
            break
        off += 12 + n
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    row = (w * channels * depth + 7) // 8 + 1
    raw = zlib.decompress(idat)
    return depth, colour, {raw[y * row] for y in range(h)}


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", PNG_KINDS)
def test_read_png_equals_cv2(kind, hw, source, tmp_path):
    """read_png equals cv2.imread bitwise, for each colour type and bit
    depth at each size."""
    path = str(tmp_path / f"{kind}.png")
    _write_png_case(kind, _crop(source, hw), path)
    depth, colour, _ = png_filters(path)
    want_header = {"rgb8": (8, 2), "grey8": (8, 0), "rgba8": (8, 6),
                   "palette_trns": (8, 3), "rgb16": (16, 2), "grey16": (16, 0)}[kind]
    if kind != "palette_trns" or hw != (1, 1):  # one colour: Pillow writes 1 bit
        assert (depth, colour) == want_header
    if kind == "palette_trns":
        assert b"tRNS" in open(path, "rb").read()
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == hw + (3,)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png_cycling_filters(path, samples, colour):
    """A PNG of ``samples`` (h, w, c) uint8 or uint16 whose row y is
    filtered with type y % 5, each filter computed from the raw bytes."""
    h, w, c = samples.shape
    depth = samples.dtype.itemsize * 8
    rows = samples.astype(samples.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    bpp = c * depth // 8
    raw = rows.astype(np.int32)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(raw), left, up, (left + up) >> 1, paeth]
    out = bytearray()
    for y in range(h):
        out += bytes([y % 5]) + ((raw[y] - preds[y % 5][y]) & 0xFF).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(bytes(out))) + _png_chunk(b"IEND", b""))


def test_read_png_sees_every_filter(source, tmp_path):
    """All five row filters (counted after inflating): those OpenCV and
    Pillow choose for the cases above at 97x61 and 1295x839, and files
    written here with row y filtered by type y % 5 (RGB and grey + alpha at
    8 bits, RGBA at 16), each equal to cv2's decode."""
    seen = set()
    for kind in PNG_KINDS:
        for hw in SIZES[2:]:
            path = str(tmp_path / f"{kind}_{hw[0]}.png")
            _write_png_case(kind, _crop(source, hw), path)
            seen |= png_filters(path)[2]
            np.testing.assert_array_equal(read_png(path), _cv2_rgb(path))
    print(f"filters OpenCV and Pillow chose: {sorted(seen)}")
    img = _crop(source, (61, 97))
    rng = np.random.default_rng(7)
    cases = {"rgb8": (img, 2), "grey_alpha8": (img[..., :2], 4),
             "rgba16": (np.concatenate([img, img[..., :1]], 2).astype(np.uint16) * 257
                        + rng.integers(0, 200, (61, 97, 4)).astype(np.uint16), 6)}
    for name, (samples, colour) in cases.items():
        path = str(tmp_path / f"cycle_{name}.png")
        _write_png_cycling_filters(path, samples, colour)
        filters = png_filters(path)[2]
        assert filters == {0, 1, 2, 3, 4}, name
        seen |= filters
        np.testing.assert_array_equal(read_png(path), _cv2_rgb(path), err_msg=name)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_read_png_below_8_bits(bits, source, tmp_path):
    """Palette and grey PNGs of 1, 2 and 4 bits, as Pillow writes them."""
    img = _crop(source, (61, 97))
    pal = str(tmp_path / "p.png")
    Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE,
                                 colors=1 << bits).save(pal, bits=bits)
    grey = str(tmp_path / "g.png")
    _write_grey_bits(grey, (img[..., 0] >> (8 - bits)).astype(np.uint8), bits)
    for path, colour in ((pal, 3), (grey, 0)):
        depth, got_colour, _ = png_filters(path)
        assert (depth, got_colour) == (bits, colour)
        np.testing.assert_array_equal(read_png(path), _cv2_rgb(path))


def _write_grey_bits(path, levels, bits):
    """A grey PNG of 1, 2 or 4 bits a sample."""
    h, w = levels.shape
    per = 8 // bits
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = levels
    packed = np.zeros((h, padded.shape[1] // per), np.uint8)
    for k in range(per):
        packed |= padded[:, k::per] << (8 - bits * (k + 1))
    raw = np.concatenate([np.zeros((h, 1), np.uint8), packed], 1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 9), (839, 1295, 3)])
def test_write_png_round_trips(shape, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(_cv2_rgb(path), want)


def test_read_png_refusals(source, tmp_path):
    """An interlaced PNG, a truncated one, a bad filter byte and a file
    that is not a PNG raise ValueErrors that name the file."""
    good = str(tmp_path / "good.png")
    write_png(good, _crop(source, (9, 17)))
    data = open(good, "rb").read()
    # IHDR's interlace byte (offset 28) set to Adam7, its CRC redone
    ihdr = bytearray(data[12:29])
    ihdr[-1] = 1
    interlaced = str(tmp_path / "adam7.png")
    with open(interlaced, "wb") as f:
        f.write(data[:12] + bytes(ihdr) + struct.pack(">I", zlib.crc32(ihdr)) + data[33:])
    truncated = str(tmp_path / "cut.png")
    open(truncated, "wb").write(data[: len(data) // 2])
    # the first row's filter byte set to 7
    raw = bytearray(zlib.decompress(data[41:41 + struct.unpack_from(">I", data, 33)[0]]))
    raw[0] = 7
    body = zlib.compress(bytes(raw))
    bad = str(tmp_path / "filter7.png")
    with open(bad, "wb") as f:
        f.write(data[:33] + struct.pack(">I", len(body)) + b"IDAT" + body
                + struct.pack(">I", zlib.crc32(b"IDAT" + body)) + b"\0\0\0\0IEND\xaeB`\x82")
    for path, match in ((interlaced, "interlaced"), (truncated, "truncated"),
                        (bad, "filter type 7"), (SOURCE.replace(".png", ".yaml"), None)):
        if match is None:
            path = str(tmp_path / "x.jpg")
            cv2.imwrite(path, _crop(source, (9, 17)))
            match = "not a PNG"
        with pytest.raises(ValueError, match=match) as e:
            read_png(path)
        assert path in str(e.value)


# ------------------------------------------------------------------- JPEG

def _jpeg_diff(path, label):
    got, want = read_jpeg(path), _cv2_rgb(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{label}: {want.shape[1]}x{want.shape[0]}, max |diff| {d.max()}, mean "
          f"{d.mean():.5f}, bitwise equal {np.mean(d == 0):.6f}")
    assert d.max() <= JPEG_MAX_DIFF and d.mean() <= JPEG_MEAN_DIFF
    return d


SAMPLING = {"444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, 0),
            "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, 1),
            "420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 2)}


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [75, 95, 100])
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_read_jpeg_matches_cv2(writer, quality, sampling, source, tmp_path):
    """Full-size JPEGs that OpenCV and Pillow write, at three qualities and
    three samplings."""
    img = _crop(source, (840, 1296))
    path = str(tmp_path / "q.jpg")
    cv_flag, pil_flag = SAMPLING[sampling]
    if writer == "cv2":
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv_flag])
    else:
        Image.fromarray(img).save(path, quality=quality, subsampling=pil_flag)
    _jpeg_diff(path, f"{writer} q{quality} {sampling}")


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "grey"])
def test_read_jpeg_odd_sizes(sampling, hw, source, tmp_path):
    """Sizes that are not a multiple of the MCU, for every sampling the
    decoder reads, 4:4:0 and grey included."""
    img = _crop(source, hw)
    path = str(tmp_path / "s.jpg")
    if sampling == "grey":
        cv2.imwrite(path, img[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    else:
        flag = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[sampling]
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    _jpeg_diff(path, f"{sampling} {hw[1]}x{hw[0]}")


@pytest.mark.parametrize("case", ["restart", "restart_every_mcu", "pil_grey",
                                  "exif3", "exif6", "exif8"])
def test_read_jpeg_restarts_grey_and_orientation(case, source, tmp_path):
    """A restart interval (RSTn markers, predictors reset), Pillow's grey
    JPEG, and EXIF orientations 3, 6 and 8 applied as cv2.imread applies
    them."""
    img = _crop(source, (61, 97))
    path = str(tmp_path / "c.jpg")
    if case.startswith("restart"):
        every = 1 if case.endswith("mcu") else 3
        cv2.imwrite(path, cv2.cvtColor(_crop(source, (839, 1295)), cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, every])
        assert b"\xff\xdd" in open(path, "rb").read() and b"\xff\xd7" in open(path, "rb").read()
    elif case == "pil_grey":
        Image.fromarray(img).convert("L").save(path, quality=95)
    else:
        exif = Image.Exif()
        exif[0x0112] = int(case[-1])
        Image.fromarray(img).save(path, exif=exif, quality=90)
    d = _jpeg_diff(path, case)
    if case in ("exif6", "exif8"):
        assert d.shape == (97, 61, 3)


def test_read_jpeg_refusals(source, tmp_path):
    """Progressive, CMYK, truncated and corrupt JPEGs raise ValueErrors that
    name the file and the feature; a truncated file never gives a partial
    image."""
    img = _crop(source, (61, 97))
    prog = str(tmp_path / "progressive.jpg")
    Image.fromarray(img).save(prog, progressive=True)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(img).convert("CMYK").save(cmyk)
    full = str(tmp_path / "full.jpg")
    cv2.imwrite(full, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    data = open(full, "rb").read()
    # the first DHT table given 3 codes of length 1: an impossible code space
    dht = data.index(b"\xff\xc4") + 5
    bad_table = str(tmp_path / "bad_table.jpg")
    open(bad_table, "wb").write(data[:dht] + b"\x03" + data[dht + 1:])
    cases = [(prog, "progressive.*SOF2"), (cmyk, "CMYK"), (bad_table, "bad Huffman table")]
    for k, cut in enumerate((len(data) // 2, len(data) - 2, 300)):
        path = str(tmp_path / f"cut{k}.jpg")
        open(path, "wb").write(data[:cut])
        cases.append((path, "truncated"))
    for path, match in cases:
        with pytest.raises(ValueError, match=match) as e:
            read_jpeg(path)
        assert path in str(e.value)


# --------------------------------------------------------------- fixtures

FIXTURE_NAMES = ["full_q95_420", "crop_444", "crop_422_restart", "crop_grey", "crop_exif6"]


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixtures(name):
    """Each committed JPEG decodes to its committed reference (cv2's decode,
    as PNG), and cv2 still decodes it so: a change to either is caught."""
    jpg = os.path.join(FIXTURES, f"{name}.jpg")
    ref = read_png(os.path.join(FIXTURES, f"{name}.png"))
    np.testing.assert_array_equal(ref, _cv2_rgb(jpg))
    d = _jpeg_diff(jpg, name)
    assert d.shape == ref.shape
    if name == "full_q95_420":
        assert ref.shape == (840, 1296, 3)
    sizes = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES) if f.endswith((".jpg", ".png")))
    assert sizes < 1 << 20


# ---------------------------------------------------------------- read_rgb

def test_read_rgb_chooses_by_signature(source, tmp_path, monkeypatch):
    """PNG always goes through read_png; JPEG through cv2, else Pillow, else
    read_jpeg; another format through cv2, else Pillow, else an
    ImportError.  The choice follows the bytes, not the file's name, and
    last_decoder names the decoder that ran."""
    img = _crop(source, (61, 97))
    png = str(tmp_path / "looks_like.jpg")  # a PNG under a JPEG's name
    write_png(png, img)
    jpg = str(tmp_path / "frame.png")  # and a JPEG under a PNG's name
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(img).save(jpg, format="JPEG", exif=exif, quality=90)
    bmp = str(tmp_path / "frame.bmp")
    cv2.imwrite(bmp, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    want = {png: img, jpg: _cv2_rgb(jpg), bmp: img}
    expected = [{png: "png", jpg: "cv2", bmp: "cv2"},
                {png: "png", jpg: "pil", bmp: "pil"},
                {png: "png", jpg: "jpeg", bmp: None}]
    for hidden, choice in zip(([], ["cv2"], ["cv2", "PIL"]), expected):
        for name in hidden:
            monkeypatch.setitem(sys.modules, name, None)
        for path, decoder in choice.items():
            tds.last_decoder = None
            if decoder is None:
                with pytest.raises(ImportError, match="PNG and baseline JPEG"):
                    tds.read_rgb(path)
                assert tds.last_decoder is None
                continue
            np.testing.assert_array_equal(tds.read_rgb(path), want[path])
            assert tds.last_decoder == decoder, (hidden, path)
    with pytest.raises(FileNotFoundError):
        tds.read_rgb(str(tmp_path / "missing.png"))


# ----------------------------------------------------------------- native

def test_decoder_library_and_signatures():
    """The decoders' library builds from the port's own source into
    _build_cache/, and every ctypes signature has as many arguments as
    its C definition."""
    lib = native.decoders()
    path = native.library_path("image_decode")
    assert path.is_file() and path.parent.name == "_build_cache"
    assert native.SOURCES["image_decode"].parent == native.CSRC
    for src in native.SOURCES.values():
        assert "gaussian_splatting_torch" in src.parts
    text = native.SOURCES["image_decode"].read_text()
    for name in ("gs_png_unfilter", "gs_jpeg_header", "gs_jpeg_decode"):
        params = re.search(rf"int {name}\(([^)]*)\)", text).group(1)
        assert len(getattr(lib, name).argtypes) == len(params.split(",")), name
        assert getattr(lib, name).restype is ctypes.c_int


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch, source):
    """No quiet fallback: when the decoders' library does not compile,
    reading a PNG or a JPEG raises with the compiler's error."""
    broken = tmp_path / "image_decode.cpp"
    broken.write_text("int gs_png_unfilter( { this is not C++ }\n")
    monkeypatch.setitem(native.SOURCES, "image_decode", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "cache")
    monkeypatch.setattr(native, "_decoders", None)
    png = str(tmp_path / "a.png")
    write_png(png, _crop(source, (9, 17)))
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, _crop(source, (9, 17)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for path in (png, jpg):
        with pytest.raises(RuntimeError, match="(?s)image decoders.*error"):
            tds.read_rgb(path)
