"""8-bit image files without OpenCV: PNG and binary PGM, on zlib and numpy.

Reads 8-bit grayscale, grayscale+alpha, RGB and RGBA PNG (non-interlaced,
all five row filters) and P5 PGM with maxval <= 255; writes grayscale or
RGB PNG and grayscale PGM.  `read_gray` converts colour to gray as
OpenCV's PNG reader does (libpng's rgb-to-gray), so it returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for these files.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples/pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential within the row
            cur = line.copy()
            up = prev
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W] uint8 for grayscale, [H, W, 3] RGB for colour (alpha is
    dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    hdr = None
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace})"
        )
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (1 + w * ch):
        raise ValueError(f"{path}: truncated PNG image data")
    img = _unfilter(raw, h, w, ch).reshape(h, w, ch)
    return img[:, :, 0] if ch <= 2 else img[:, :, :3]


def _pnm_tokens(data: bytes, count: int):
    """The first `count` header tokens of a PNM file and the offset of the
    byte after the single whitespace that ends the header."""
    toks, pos = [], 0
    while len(toks) < count:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        toks.append(data[start:pos])
    return toks, pos + 1


def read_pgm(path: str) -> np.ndarray:
    """Binary (P5) PGM with maxval <= 255 -> [H, W] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    toks, off = _pnm_tokens(data, 4)
    if toks[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    w, h, maxval = int(toks[1]), int(toks[2]), int(toks[3])
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM is not supported")
    if len(data) - off < w * h:
        raise ValueError(f"{path}: truncated PGM image data")
    return np.frombuffer(data, np.uint8, w * h, off).reshape(h, w).copy()


def read_image(path: str) -> np.ndarray:
    """PNG or PGM by content: [H, W] gray or [H, W, 3] RGB uint8."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIG:
        return read_png(path)
    if head[:2] == b"P5":
        return read_pgm(path)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """8-bit RGB -> gray as libpng converts it for OpenCV's grayscale PNG
    read: weights 0.299 and 0.587 in 15-bit fixed point (9797, 19234 and
    the remainder 3737 for blue), truncated."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * 9797 + c[..., 1] * 19234 + c[..., 2] * 3737
    return (y >> 15).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """[H, W] uint8 grayscale of a PNG or PGM file."""
    img = read_image(path)
    return img if img.ndim == 2 else rgb_to_gray(img)


def read_gray_or_none(path: str) -> Optional[np.ndarray]:
    """read_gray, or None when the file is not a readable PNG/PGM (as
    cv2.imread returns None)."""
    try:
        return read_gray(path)
    except (OSError, ValueError):
        return None


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """[H, W] gray or [H, W, 3] RGB uint8 -> PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, ch = 2, 3
    else:
        raise ValueError(f"cannot write image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def write_pgm(path: str, img: np.ndarray) -> None:
    """[H, W] uint8 -> binary PGM."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"cannot write image of shape {img.shape} as PGM")
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def write_image(path: str, img: np.ndarray) -> None:
    """Write PNG or PGM, chosen by the file extension."""
    if path.lower().endswith(".pgm"):
        write_pgm(path, img)
    else:
        write_png(path, img)
