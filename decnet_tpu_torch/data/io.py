"""Image and disparity file I/O — the port of decnet_tpu/data/io.py, with
no PIL and no cv2 (the card's machine has neither).

PNG files are read and written here: the chunks are parsed in Python, the
image data inflated by the standard library's `zlib`, and the scanline
filters (None, Sub, Up, Average, Paeth) undone by
`csrc/host/png_unfilter.cc`, built by g++ at first use
(`ops/kernels/build.py`).  8- and 16-bit gray, gray+alpha, RGB and RGBA
are read; palette, interlaced and 1/2/4-bit files are refused with an
error.  Written files are 8-bit gray/RGB/RGBA or 16-bit gray, filter 0.

JPEG files (DrivingStereo's images) are decoded by
`csrc/host/jpeg_decode.cc`, built by g++ at first use like the PNG
unfilter and called through ctypes: baseline and extended-sequential
Huffman files of 8-bit gray or YCbCr, equal in every pixel to
`cv2.imread` (libjpeg-turbo's ISLOW inverse DCT, fancy upsampling and
fixed-point colour conversion).  Progressive, arithmetic-coded, lossless,
12-bit, CMYK and RGB-coded files, and files with an EXIF orientation other
than 1 (cv2 would rotate them), are refused with NotImplementedError.
`read_image` and `read_disparity_png` pick the decoder by the file's
first bytes, not by its extension.

PFM files (SceneFlow's disparities) are read and written in numpy
(`read_pfm`, `write_pfm`) or decoded by `native/decnet_native.cc`
(`decode_pfm`).  `pad_to_multiple` and `normalize_image` work on (B,3,H,W)
tensors on any device; `pad_to_multiple_np` and `normalize_image_np` are
their numpy twins for host samples (H,W[,C])."""
from __future__ import annotations

import ctypes
import math
import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.kernels import build

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_MEAN_NP = np.array(IMAGENET_MEAN, np.float32)
_STD_NP = np.array(IMAGENET_STD, np.float32)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
# PNG colour type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def pad_to_multiple(img: torch.Tensor, multiple: int = 27) -> torch.Tensor:
    """Zero-pad top and left so H and W are multiples of `multiple`."""
    h, w = img.shape[-2:]
    rh = -h % multiple
    rw = -w % multiple
    return F.pad(img, (rw, 0, rh, 0))


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (B,3,H,W) -> ImageNet-normalised f32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=img.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=img.device).view(1, 3, 1, 1)
    return (img.float() - mean) / std


def pad_to_multiple_np(img: np.ndarray, multiple: int = 27) -> np.ndarray:
    """Zero-pad top-left so H, W of (H,W[,C]) are multiples of `multiple`."""
    h, w = img.shape[:2]
    pads = [(-h % multiple, 0), (-w % multiple, 0)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads)


def normalize_image_np(img: np.ndarray) -> np.ndarray:
    """[0,1] RGB (H,W,3) -> ImageNet-normalised float32."""
    return (img.astype(np.float32) - _MEAN_NP) / _STD_NP


# -- PNG ----------------------------------------------------------------

def _png_chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter(raw: bytes, rows: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    lib = build.load(build.PNG_LIB, {"decnet_png_unfilter": [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]}, restype=ctypes.c_int64)
    out = np.empty((rows, stride), np.uint8)
    bad = lib.decnet_png_unfilter(raw, rows, stride, bpp,
                                  out.ctypes.data_as(ctypes.c_void_p))
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has an unknown filter type")
    return out


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The samples of a PNG file's bytes as stored: (H,W) for gray, else
    (H,W,C) with C 2 / 3 / 4 (gray+alpha, RGB, RGBA) in file order;
    uint8 or uint16."""
    header, idat = None, []
    for kind, payload in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         f"supported; gray, gray+alpha, RGB and RGBA are")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported; "
                         f"8 and 16 are")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown PNG compression / filter method")
    ch, nbytes = _PNG_CHANNELS[ctype], depth // 8
    stride = w * ch * nbytes
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"{h * (stride + 1)} expected")
    rows = _unfilter(raw, h, stride, ch * nbytes, path)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H,W) / (H,W,3) / (H,W,4) or uint16 (H,W)
    image: every scanline filter 0 (None), zlib at `level`."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (3, 4))):
        depth = 8
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write a PNG of {img.dtype} {img.shape}: "
                         f"uint8 gray/RGB/RGBA or uint16 gray")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """`encode_png` into a file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- JPEG ---------------------------------------------------------------

def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes: (H,W) uint8 for gray, (H,W,3)
    uint8 RGB for colour, by `csrc/host/jpeg_decode.cc`.  A file of a kind
    the decoder refuses raises NotImplementedError, a corrupt one
    ValueError; both name `path`."""
    lib = build.load(build.JPEG_LIB, {"decnet_jpeg_decode": [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]})
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)

    def call(out, cap):
        return lib.decnet_jpeg_decode(data, len(data), out, cap,
                                      ctypes.byref(h), ctypes.byref(w),
                                      ctypes.byref(c), msg, len(msg))

    rc = call(None, 0)
    if rc == 3:
        img = np.empty((h.value, w.value, c.value), np.uint8)
        rc = call(img.ctypes.data_as(ctypes.c_void_p), img.size)
    if rc == 1:
        raise NotImplementedError(f"{path}: {msg.value.decode()} is not "
                                  f"decoded; baseline 8-bit gray or YCbCr "
                                  f"JPEG is (ROADMAP.md section 3)")
    if rc != 0:
        raise ValueError(f"{path}: {msg.value.decode()}")
    return img[..., 0] if c.value == 1 else img


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


# -- the readers the datasets and the demo use --------------------------

def _read_samples(path: str) -> Tuple[np.ndarray, bool]:
    """(a PNG's samples or a JPEG's pixels, whether it was a JPEG), by the
    file's first bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, path), True
    return decode_png(data, path), False


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H,W,3) of a PNG or JPEG file, as cv2.imread(IMREAD_COLOR)
    then BGR->RGB reads it: gray replicated, alpha dropped, 16-bit samples
    cut to their high byte."""
    img, _ = _read_samples(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 2:
        img = np.repeat(img[..., :1], 3, axis=2)
    else:
        img = img[..., :3]
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return np.ascontiguousarray(img)


def read_disparity_png(path: str, scale: float = 256.0) -> np.ndarray:
    """KITTI / DrivingStereo disparity file, value / scale, f32: its samples
    as cv2.imread(IMREAD_UNCHANGED) reads them (a uint16 PNG; a colour JPEG
    in BGR order)."""
    img, is_jpeg = _read_samples(path)
    if is_jpeg and img.ndim == 3:
        img = img[..., ::-1]
    return img.astype(np.float32) / scale


def write_submission_png(path: str, disp: np.ndarray,
                         ori_h: Optional[int] = None,
                         ori_w: Optional[int] = None):
    """uint16 PNG of clip(disp * 256, 0, 65535), cropped to the bottom-right
    ori_h x ori_w (the padding was added top-left)."""
    out = np.clip(np.asarray(disp) * 256.0, 0, 65535).astype(np.uint16)
    if ori_h is not None:
        out = out[-ori_h:, -ori_w:]
    write_png(path, out)


def read_calib_ndisp(path: str, align: int = 27) -> Optional[int]:
    """Per-scene disparity range from a Middlebury-style calib.txt (last
    line `ndisp=N`), rounded up to a multiple of `align`."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        lines = f.readlines()
    n = float(lines[-1].strip().split("=")[-1])
    return int(math.ceil(n / align) * align)


# -- PFM ----------------------------------------------------------------

def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Portable float map (SceneFlow's disparity format): (data, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().decode()
        m = re.match(r"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip().decode())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(data).astype("<f").tofile(f)


_PFM_HEADER = re.compile(rb"P([Ff])\s*(\S+)\s+(\S+)\s+(\S+)")


def pfm_header(data: bytes) -> Tuple[int, int, int]:
    """(h, w, c) of PFM bytes, parsed as `native/decnet_native.cc::
    decnet_decode_pfm` parses them ("PF"/"Pf", then width, height and
    scale separated by whitespace)."""
    m = _PFM_HEADER.match(data)
    if not m:
        raise ValueError("not a PFM header")
    try:
        w, h = int(float(m.group(2))), int(float(m.group(3)))
    except ValueError:
        raise ValueError("malformed PFM header") from None
    if h <= 0 or w <= 0:
        raise ValueError(f"PFM header claims {w}x{h}")
    return h, w, 3 if m.group(1) == b"F" else 1


def decode_pfm(data: bytes, max_pixels: int = 1 << 26) -> np.ndarray:
    """PFM bytes decoded by `native/decnet_native.cc`: (H,W) or (H,W,3)
    float32.  The header is read here first: the native decoder writes
    h*w*c floats without a bound, so the buffer is sized from the header,
    and a header claiming more than `max_pixels` values is refused."""
    h, w, c = pfm_header(data)
    n = h * w * c
    if n > max_pixels:
        raise ValueError(f"PFM of {w}x{h}x{c} = {n} values exceeds "
                         f"max_pixels={max_pixels}")
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int)
    lib = build.load(build.HOST_LIB, {"decnet_decode_pfm": [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, pf, pi, pi, pi]},
        restype=ctypes.c_int)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.float32)
    oh, ow, oc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.decnet_decode_pfm(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(pf), ctypes.byref(oh), ctypes.byref(ow),
        ctypes.byref(oc))
    if rc != 0:
        raise ValueError(f"PFM decode failed rc={rc}")
    if (oh.value, ow.value, oc.value) != (h, w, c):
        raise ValueError(f"PFM header read as {(h, w, c)} here and "
                         f"{(oh.value, ow.value, oc.value)} natively")
    return out.reshape((h, w, 3) if c == 3 else (h, w))
