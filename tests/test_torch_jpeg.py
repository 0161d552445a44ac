"""The port's JPEG decoder (decnet_tpu_torch/csrc/host/jpeg_decode.cc,
through data/io.py) against cv2.imread on files cv2 writes here: every
chroma subsampling cv2 offers, gray, several qualities, odd sizes that
leave partial MCUs, a restart interval, and the refusals.  Equality is
exact, pixel for pixel: the decoder repeats libjpeg-turbo's integer
arithmetic.  The committed DrivingStereo fixture's decodes are also held
to the SHA-256s its manifest recorded from cv2."""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from decnet_tpu_torch.data import io as dio

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "drivingstereo")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def scene(h, w, seed=0):
    """uint8 (h,w,3): smooth colour waves, noise and a saturated box."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0)
                    for c in range(3)], axis=-1)
    img += rng.randn(h, w, 3) * 20
    img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = (250, 10, 30)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def write(tmp_path, img, params, name="t.jpg"):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img, params)
    return path


@pytest.mark.parametrize("hw", [(37, 53), (64, 80), (9, 17), (2, 3)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_subsamplings_and_sizes_equal_cv2(sampling, hw, tmp_path):
    for q in (50, 75, 95, 100):
        path = write(tmp_path, scene(*hw), [
            cv2.IMWRITE_JPEG_QUALITY, q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        got = dio.read_image(path)
        assert got.dtype == np.uint8 and got.shape == hw + (3,)
        assert np.array_equal(got, cv2_rgb(path)), q


@pytest.mark.parametrize("params", [
    [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    [cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 90],
    [cv2.IMWRITE_JPEG_LUMA_QUALITY, 30, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 80],
], ids=["rst3", "rst1_420", "optimized", "luma_chroma"])
def test_restarts_and_tables_equal_cv2(params, tmp_path):
    path = write(tmp_path, scene(45, 71, seed=1), params)
    assert np.array_equal(dio.read_image(path), cv2_rgb(path))


@pytest.mark.parametrize("hw", [(37, 53), (16, 16)])
def test_gray_equals_cv2(hw, tmp_path):
    path = write(tmp_path, scene(*hw)[..., 1], [cv2.IMWRITE_JPEG_QUALITY,
                                                 85])
    assert np.array_equal(dio.read_image(path), cv2_rgb(path))
    gray = dio.read_jpeg(path)
    assert gray.shape == hw
    assert np.array_equal(gray, cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_extension_does_not_decide(tmp_path):
    """read_image picks the decoder by the file's first bytes."""
    path = write(tmp_path, scene(20, 30), [cv2.IMWRITE_JPEG_QUALITY, 80])
    renamed = str(tmp_path / "t.png")
    os.rename(path, renamed)
    assert np.array_equal(dio.read_image(renamed), cv2_rgb(renamed))


def test_refusals(tmp_path):
    path = write(tmp_path, scene(40, 40), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        dio.read_image(path)
    # an EXIF orientation other than 1: cv2 would rotate the pixels
    data = open(write(tmp_path, scene(24, 40), []), "rb").read()
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08\x00\x01"
            b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
            b"\x00\x00\x00\x00")
    app1 = b"Exif\x00\x00" + tiff
    rotated = data[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big") \
        + app1 + data[2:]
    with pytest.raises(NotImplementedError, match="orientation 6"):
        dio.decode_jpeg(rotated)
    # orientation 1 is read
    upright = rotated.replace(b"\x00\x06\x00\x00\x00\x00\x00\x00",
                              b"\x00\x01\x00\x00\x00\x00\x00\x00")
    assert dio.decode_jpeg(upright).shape == (24, 40, 3)
    with pytest.raises(ValueError):
        dio.decode_jpeg(data[:len(data) // 3])


def test_fixture_decodes_match_manifest():
    with open(os.path.join(FIXTURE, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest["rgb_sha256"]) == 2 * manifest["scenes"]
    for rel, want in manifest["rgb_sha256"].items():
        path = os.path.join(FIXTURE, "test", rel)
        img = dio.read_image(path)
        assert img.shape == tuple(manifest["size"]) + (3,)
        assert hashlib.sha256(img.tobytes()).hexdigest() == want, rel
        assert np.array_equal(img, cv2_rgb(path)), rel
