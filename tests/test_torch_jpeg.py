"""Baseline JPEG decoding and encoding (``gims_tpu_torch/core/jpeg.py``)
against OpenCV's libjpeg-turbo on the CPU.

The JAX package reads and writes JPEG with ``cv2.imread`` / ``cv2.imwrite``
at their defaults, so cv2 is the reference. Decoding is held bit-equal to
``cv2.imread`` / ``cv2.imdecode`` (``IMREAD_COLOR`` and
``IMREAD_GRAYSCALE``) on the repo's six photos and on seeded images that
cv2 encodes at qualities 50/75/95 with 4:4:4, 4:2:2, 4:2:0 and 4:4:0
sampling, gray, and restart intervals; SOF1 frames and EXIF orientations
too. Encoding is held to the bytes of ``cv2.imencode(".jpg", img)`` at
qualities 50/75/95, colour and gray, odd sizes included.
"""

import glob
import os
import struct

import cv2
import numpy as np
import pytest

from gims_tpu_torch.core import image_io, jpeg
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOS = sorted(glob.glob(os.path.join(REPO, "assets", "photos", "*.jpg")))
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111}
SIZES = ((37, 53), (64, 48), (17, 2), (1, 1))


def seeded_image(seed, h, w, channels=3):
    """A smooth texture with noise: every DCT frequency in use."""
    rng = np.random.RandomState(seed)
    low = rng.randint(0, 256, (max(h // 6, 1), max(w // 6, 1), 3)).astype(np.uint8)
    base = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(base.astype(np.int32) + rng.randint(-20, 21, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img if channels == 3 else np.ascontiguousarray(img[..., 0])


def equal_to_cv2(data):
    buf = np.frombuffer(data, np.uint8)
    for flags in (image_io.IMREAD_COLOR, image_io.IMREAD_GRAYSCALE):
        got = jpeg.decode_jpeg(data, flags)
        want = cv2.imdecode(buf, flags)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_assets_are_the_six_baseline_photos():
    assert len(PHOTOS) == 6
    for path in PHOTOS:
        with open(path, "rb") as f:
            assert b"\xff\xc0" in f.read()  # SOF0


@pytest.mark.parametrize("path", PHOTOS, ids=os.path.basename)
@pytest.mark.parametrize("flags", [image_io.IMREAD_COLOR, image_io.IMREAD_GRAYSCALE])
def test_decode_photos_bit_equal_to_cv2(path, flags):
    got = image_io.imread(path, flags)
    want = cv2.imread(path, flags)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
@pytest.mark.parametrize("restart", [0, 3])
def test_decode_seeded_cv2_files(quality, sampling, restart):
    for i, (h, w) in enumerate(SIZES):
        img = seeded_image(quality + i, h, w, 1 if sampling == "gray" else 3)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if sampling != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        equal_to_cv2(buf.tobytes())


def test_decode_extended_sequential_frame():
    """SOF1 (extended sequential, Huffman, 8-bit) decodes as SOF0 does."""
    ok, buf = cv2.imencode(".jpg", seeded_image(3, 40, 56))
    data = bytearray(buf.tobytes())
    i = data.index(b"\xff\xc0")
    data[i + 1] = 0xC1
    np.testing.assert_array_equal(jpeg.decode_jpeg(bytes(data)), cv2.imdecode(buf, 1))


def exif_app1(orientation):
    ifd = struct.pack("<HHHIHH", 1, 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    tiff = b"II*\0" + struct.pack("<I", 8) + ifd
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_decode_applies_exif_orientation_as_cv2(orientation):
    ok, buf = cv2.imencode(".jpg", seeded_image(orientation, 24, 40))
    data = buf.tobytes()
    data = data[:2] + exif_app1(orientation) + data[2:]
    equal_to_cv2(data)


def test_unsupported_kinds_raise_naming_roadmap():
    img = seeded_image(5, 32, 32)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    base = cv2.imencode(".jpg", img)[1].tobytes()
    i = base.index(b"\xff\xc0")
    arithmetic = base[:i + 1] + b"\xc9" + base[i + 2:]
    twelve_bit = base[:i + 4] + b"\x0c" + base[i + 5:]
    for data in (prog.tobytes(), arithmetic, twelve_bit):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            jpeg.decode_jpeg(data)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(base[: len(base) // 2])  # cut inside the scan
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("channels", [3, 1])
def test_encode_equals_cv2_imencode(quality, channels):
    for i, (h, w) in enumerate(SIZES + ((120, 160),)):
        img = seeded_image(100 + quality + i, h, w, channels)
        ours = jpeg.encode_jpeg(img, quality)
        ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ours == ref.tobytes(), (h, w)
        # the port's decoder reads the port's bytes as cv2 reads them
        equal_to_cv2(ours)


def test_image_io_reads_and_writes_jpeg(tmp_path):
    img = seeded_image(9, 45, 61)
    path = tmp_path / "a.jpg"
    assert image_io.imwrite(str(path), img)
    assert path.read_bytes() == cv2.imencode(".jpg", img)[1].tobytes()
    np.testing.assert_array_equal(image_io.imread(str(path)), cv2.imread(str(path)))
    ok, buf = image_io.imencode(".jpeg", img)
    assert ok and buf.tobytes() == path.read_bytes()
    np.testing.assert_array_equal(image_io.imdecode(buf, image_io.IMREAD_GRAYSCALE),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    # imdecode dispatches on the signature: PNG and BMP too
    np.testing.assert_array_equal(image_io.imdecode(image_io.imencode(".png", img)[1]), img)
    ok, bmp = cv2.imencode(".bmp", img)
    np.testing.assert_array_equal(image_io.imdecode(bmp), img)
