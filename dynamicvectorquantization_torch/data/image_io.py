"""Image files -> uint8 arrays and their Pillow mode, without PIL for the
formats the datasets hold (JPEG, 8-bit PNG).

`read_image(path, min_side)` returns `(array, mode)`: an (H, W, C) uint8
array and the mode Pillow's image would have on the JAX package's path
(`dynamicvectorquantization_tpu/data/datasets.py` `FileListDataset._open`),
which the transforms (`data/transforms.py`) carry to the end:

  * `.jpg` / `.jpeg` (any case): the JAX package's native decode, libjpeg's
    pixels with its DCT-domain downscale by the largest of 8, 4, 2 that keeps
    the short side at least `min_side` (`native.decode_jpeg`: libjpeg, or the
    port's decoder where libjpeg is absent), mode RGB. Where
    libjpeg refuses the stream (a PNG named `.JPEG`, a CMYK JPEG), the JAX
    package opens the bytes with PIL at full size; here the bytes are decoded
    by their content as PIL would, at full size.
  * any other extension: full size, decoder by content.

By content: a JPEG at full size in Pillow's mode (L, RGB, or CMYK inverted
as Pillow's "CMYK;I" raw mode stores it); a PNG of 8 bits a sample, not
interlaced, colour type 0 (L), 2 (RGB), 3 (P), 4 (LA) or 6 (RGBA), inflated
with `zlib` and unfiltered in C++. A palette image is returned with its
palette applied (RGB values) and mode "P", which tells the resize to take
NEAREST as Pillow does for palette images; nearest sampling and the palette
lookup commute. Anything else (16-bit or sub-byte PNGs, Adam7, BMP, WebP,
...) goes through PIL where it is installed, and raises naming the file
where it is not.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from .. import native

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
# PNG colour type -> (mode, samples a pixel)
_PNG_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}
# modes the transforms carry, with the array's channels
CHANNELS = {"L": 1, "1": 1, "LA": 2, "RGB": 3, "P": 3, "RGBA": 4, "CMYK": 4}
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT")


class ImageReadError(ValueError):
    """A file that cannot be read here; the message names it and why."""


def read_image(path: str, min_side: int | None = None) -> tuple[np.ndarray, str]:
    """(array, mode) of the image file at `path`, routed as the JAX
    package's `FileListDataset._open` routes it (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            arr = native.decode_jpeg(data, min_side=min_side)
        except RuntimeError as e:  # the host library could not be built
            raise ImageReadError(f"{path}: {e}") from e
        if arr is not None:
            return arr, "RGB"
    return decode_image(data, path)


def decode_image(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, str]:
    """(array, mode) of encoded image bytes at full size, decoded by their
    content as `PIL.Image.open` decodes them."""
    try:
        if data[:8] == PNG_MAGIC:
            decoded, reason = _decode_png(data)
            return decoded if decoded is not None else _via_pil(data, reason)
        if data[:3] == JPEG_MAGIC:
            return native.decode_jpeg_full(data)
        return _via_pil(data, "neither a JPEG nor a PNG")
    except (ValueError, RuntimeError, zlib.error, struct.error) as e:
        raise ImageReadError(f"{name}: {e}") from e


def _decode_png(data: bytes):
    """((array, mode), None), or (None, why) for a PNG this reader leaves to
    PIL. Raises ValueError for a broken file."""
    pos, ihdr, plte, idat = 8, None, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG (no IEND chunk)")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        if tag in _CRITICAL and zlib.crc32(tag + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file: CRC of chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or len(ihdr) != 13:
        raise ValueError("PNG without a valid IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if ctype not in _PNG_TYPES:
        raise ValueError(f"PNG colour type {ctype}")
    if depth != 8 or interlace:
        return None, (f"a PNG of {depth} bits a sample{', interlaced (Adam7)' if interlace else ''}"
                      " is read only through PIL")
    mode, spp = _PNG_TYPES[ctype]
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * spp, spp)
    arr = rows.reshape(h, w, spp)
    if mode == "P":
        if plte is None:
            raise ValueError("palette PNG without a PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[:len(plte) // 3 * 3].reshape(-1, 3)
        palette[:len(entries)] = entries[:256]
        arr = palette[arr[..., 0]]
    return (arr, mode), None


def _via_pil(data: bytes, reason: str) -> tuple[np.ndarray, str]:
    """PIL's decode of the bytes in a mode the transforms carry."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(f"{reason}, and PIL, which would read it, is not installed") from e
    with Image.open(io.BytesIO(data)) as im:
        mode = im.mode
        if mode in ("P", "1"):
            arr = np.asarray(im.convert("RGB" if mode == "P" else "L"))
        elif mode in CHANNELS:
            arr = np.asarray(im)
        else:
            raise ValueError(f"mode {mode} ({reason}) is not supported")
    arr = np.ascontiguousarray(arr)
    return (arr[..., None] if arr.ndim == 2 else arr), mode
