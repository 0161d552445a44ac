"""The port's file I/O (decnet_tpu_torch/data/io.py: PNG without PIL or
cv2, PFM) against cv2, PIL and decnet_tpu/data/io.py.

The decoder must equal cv2.imread in every pixel on files written by cv2,
by PIL, and by an encoder here that sets every row's filter type in turn
(None, Sub, Up, Average, Paeth): the three together hold all five."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from decnet_tpu.data import io as jio
from decnet_tpu.data import native as jnative
from decnet_tpu_torch.data import io as tio

H, W = 45, 77


def natural(rng, h=H, w=W, c=3, dtype=np.uint8):
    """Smooth gradients with noise and sharp rows: content on which
    adaptive filtering picks several filter types."""
    top = 255 if dtype == np.uint8 else 65535
    yy, xx = np.mgrid[:h, :w]
    base = (np.sin(xx / 9.0)[..., None] * 0.3 + np.cos(yy / 7.0)[..., None]
            * 0.3 + 0.5 + rng.rand(h, w, c) * 0.1 * np.arange(1, c + 1))
    base[::5] = rng.rand(len(base[::5]), w, c)
    img = np.clip(base * top, 0, top).astype(dtype)
    return img[..., 0] if c == 1 else img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_with_every_filter(img):
    """PNG bytes of img (uint8 gray/RGB/RGBA or uint16 gray) whose row y
    uses filter type y % 5."""
    depth = 16 if img.dtype == np.uint16 else 8
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img)
    rows = rows.reshape(img.shape[0], -1).astype(np.int64)
    bpp = ch * depth // 8
    out = []
    prev = np.zeros_like(rows[0])
    for y, row in enumerate(rows):
        t = y % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][t]
        out.append(np.concatenate([[t], (row - pred) & 0xFF]))
        prev = row
    raw = np.stack(out).astype(np.uint8).tobytes()

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype,
                       0, 0, 0)
    return (tio.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def filter_types(path):
    """The set of filter types of a PNG file's rows."""
    data = open(path, "rb").read()
    chunks = list(tio._png_chunks(data, path))
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[0][1][:10])
    stride = w * tio._PNG_CHANNELS[ctype] * depth // 8
    raw = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    return {raw[y * (stride + 1)] for y in range(h)}


def cv2_samples(path):
    """cv2.imread(IMREAD_UNCHANGED) with the channels in file order."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


KINDS = {"rgb8": (3, np.uint8), "gray16": (1, np.uint16),
         "rgba8": (4, np.uint8)}


@pytest.mark.parametrize("kind", KINDS)
def test_png_decoder_equals_cv2(kind, tmp_path):
    ch, dtype = KINDS[kind]
    rng = np.random.RandomState(len(kind))
    img = natural(rng, c=ch, dtype=dtype)
    paths = {"ours": tmp_path / "f.png", "cv2": tmp_path / "c.png",
             "pil": tmp_path / "p.png"}
    paths["ours"].write_bytes(png_with_every_filter(img))
    cv2.imwrite(str(paths["cv2"]), img if ch == 1 else
                img[..., [2, 1, 0, 3][:ch]])
    Image.fromarray(img if ch > 1 else img.astype(np.uint16)).save(
        paths["pil"])
    types = set()
    for who, path in paths.items():
        got = tio.read_png(str(path))
        assert got.dtype == dtype and np.array_equal(got, cv2_samples(path)), \
            who
        assert np.array_equal(got, img), who
        types |= filter_types(str(path))
        # the datasets' reader: RGB uint8 as cv2 IMREAD_COLOR + BGR->RGB
        want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        assert np.array_equal(tio.read_image(str(path)), want), who
    assert types == {0, 1, 2, 3, 4}


def test_png_encoder_round_trip_and_refusals(tmp_path):
    rng = np.random.RandomState(1)
    for img in (natural(rng), natural(rng, c=4), natural(rng, c=1),
                natural(rng, c=1, dtype=np.uint16)):
        path = str(tmp_path / "x.png")
        tio.write_png(path, img)
        assert np.array_equal(cv2_samples(path), img)
        assert np.array_equal(tio.read_png(path), img)
    Image.fromarray(natural(rng)).convert("P").save(tmp_path / "pal.png")
    with pytest.raises(ValueError, match="palette"):
        tio.read_png(str(tmp_path / "pal.png"))
    data = bytearray(tio.encode_png(natural(rng)))
    data[28] = 1                      # IHDR's interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlaced"):
        tio.decode_png(bytes(data))
    bad = bytearray((tmp_path / "x.png").read_bytes())
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        tio.decode_png(bytes(bad))


def test_jpeg_refused_naming_the_roadmap_item(tmp_path):
    """Baseline JPEG is read (tests/test_torch_jpeg.py); a progressive
    file is refused, naming the roadmap's record of the refusals."""
    path = str(tmp_path / "a.jpg")
    img = natural(np.random.RandomState(0))
    cv2.imwrite(path, img)
    assert tio.read_image(path).shape == img.shape
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError,
                       match=r"progressive .*ROADMAP.md section 3"):
        tio.read_image(path)


@pytest.mark.parametrize("crop", [None, (40, 60)])
def test_submission_png_equals_jax(crop, tmp_path):
    rng = np.random.RandomState(2)
    disp = (rng.rand(H, W) * 300 - 20).astype(np.float32)   # clipped ends
    kw = dict(ori_h=crop[0], ori_w=crop[1]) if crop else {}
    jio.write_submission_png(str(tmp_path / "j.png"), disp, **kw)
    tio.write_submission_png(str(tmp_path / "t.png"), disp, **kw)
    want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    for path in ("j.png", "t.png"):
        for got in (tio.read_png(str(tmp_path / path)),
                    cv2.imread(str(tmp_path / path), cv2.IMREAD_UNCHANGED)):
            assert got.dtype == np.uint16 and np.array_equal(got, want)
    assert want.shape == (crop or (H, W))
    np.testing.assert_array_equal(
        tio.read_disparity_png(str(tmp_path / "t.png")),
        jio.read_disparity_png(str(tmp_path / "j.png")))


@pytest.mark.parametrize("color", [False, True])
def test_pfm_round_trip_against_jax(color, tmp_path):
    rng = np.random.RandomState(3)
    data = rng.randn(*((H, W, 3) if color else (H, W))).astype(np.float32)
    tio.write_pfm(str(tmp_path / "t.pfm"), data)
    jio.write_pfm(str(tmp_path / "j.pfm"), data)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    got, scale = tio.read_pfm(str(tmp_path / "t.pfm"))
    want, jscale = jio.read_pfm(str(tmp_path / "t.pfm"))
    assert np.array_equal(got, want) and np.array_equal(got, data)
    assert scale == jscale == 1.0
    raw = (tmp_path / "t.pfm").read_bytes()
    assert np.array_equal(tio.decode_pfm(raw), data)
    if jnative.available():
        assert np.array_equal(tio.decode_pfm(raw), jnative.decode_pfm(raw))


def test_decode_pfm_refuses_a_header_beyond_its_bound():
    """decode_pfm reads the header before the native decoder writes: the
    buffer is the header's size, and a header claiming more than
    max_pixels values is refused (the native decoder writes h*w*c floats
    with no bound)."""
    rng = np.random.RandomState(5)
    data = rng.randn(8, 8).astype(np.float32)
    raw = b"Pf\n8 8\n-1.0\n" + np.flipud(data).astype("<f").tobytes()
    with pytest.raises(ValueError, match="max_pixels"):
        tio.decode_pfm(raw, max_pixels=63)
    with pytest.raises(ValueError, match="max_pixels"):
        tio.decode_pfm(b"PF\n8192 8192\n-1.0\n" + bytes(64))
    assert np.array_equal(tio.decode_pfm(raw, max_pixels=64), data)
    assert tio.pfm_header(raw) == (8, 8, 1)
    for bad in (b"P6\n8 8\n-1.0\n", b"Pf\n-8 8\n-1.0\n",
                b"Pf\nx 8\n-1.0\n"):
        with pytest.raises(ValueError):
            tio.decode_pfm(bad + bytes(256))


def test_numpy_twins_equal_jax():
    rng = np.random.RandomState(4)
    img = rng.rand(50, 70, 3).astype(np.float32)
    assert np.array_equal(tio.pad_to_multiple_np(img, 27),
                          jio.pad_to_multiple(img, 27))
    assert np.array_equal(tio.pad_to_multiple_np(img[..., 0], 9),
                          jio.pad_to_multiple(img[..., 0], 9))
    got, want = tio.normalize_image_np(img), jio.normalize_image(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
