"""The host input pipeline's native code, bound with ctypes (counterpart of
`dynamicvectorquantization_tpu/native/`).

Two shared libraries, each compiled by `g++` at its first use into
`build/host/` beside the repository's other builds:

  * `image_core` (`image_core.cpp`, `jpeg_decoder.cpp`; no third-party
    header): Pillow's resampler on 8-bit images (`resample`), PNG row
    unfiltering (`png_unfilter`), and a baseline / progressive JPEG decoder
    that reproduces libjpeg-turbo's pixels (its integer IDCTs, DCT scaling,
    fancy upsampling and colour tables);
  * `jpeg` (`host_pipeline.cpp`, links `-ljpeg`): the JAX package's libjpeg
    decode.

JPEGs (`decode_jpeg`: RGB with libjpeg's DCT-domain downscale by the JAX
package's denominator rule; `decode_jpeg_full`: full size in the mode Pillow
opens the file in) go through libjpeg where the `jpeg` library builds and
loads, else through the `image_core` decoder, which gives the same arrays
(tests/test_torch_image_io.py holds it to libjpeg). The choice is made once
a process, printed on a line of its own when made, and named by
`decoder_name()`.

A library's file name carries a hash of its source and flags, so an edited
source is rebuilt; a finished build is moved into place atomically, under a
file lock, so several processes may load it at once. No OpenMP: the loader's
worker threads already spread images over cores, and ctypes releases the GIL
for the length of a call. A library that cannot be built raises, with the
compiler's output, from every function that needs it; the PNG path needs only
the first. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "host")
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
# library -> (source, link flags)
LIBRARIES = {"image_core": (("image_core.cpp", "jpeg_decoder.cpp"), ()),
             "jpeg": (("host_pipeline.cpp",), ("-ljpeg",))}

NEAREST, BILINEAR, BICUBIC = 0, 2, 3  # PIL.Image's numbering

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "image_core": {
        "dqvq_resample": (_P, _I, _I, _I, _P, _I, _I, _I),
        "dqvq_png_unfilter": (_P, _L, _I, _L, _I, _P),
        "dqvq_jpeg_port_header": (ctypes.c_char_p, _L, _IP, _IP, _IP, ctypes.c_char_p, _I),
        "dqvq_jpeg_port_decode": (ctypes.c_char_p, _L, _I, _I, _P, _L, _IP, _IP,
                                  ctypes.c_char_p, _I),
        "dqvq_jpeg_port_coefficients": (ctypes.c_char_p, _L, _IP, _P, _L, ctypes.c_char_p, _I),
    },
    "jpeg": {
        "dqvq_decode_jpeg": (ctypes.c_char_p, _L, _I, _P, _L, _IP, _IP),
        "dqvq_jpeg_header": (ctypes.c_char_p, _L, _IP, _IP, _IP, ctypes.c_char_p, _I),
        "dqvq_decode_jpeg_full": (ctypes.c_char_p, _L, _I, _P, _L, _IP, _IP,
                                  ctypes.c_char_p, _I),
        "dqvq_jpeg_version": (_IP, _IP),
    },
}
RESTYPES = {"dqvq_jpeg_version": None, "dqvq_jpeg_port_coefficients": ctypes.c_long}

_lock = threading.Lock()
_loaded: dict = {}  # library -> ctypes.CDLL, or the RuntimeError its build raised
build_seconds: dict = {}  # library -> seconds this process spent building it
_jpeg_backend: list = []  # ["libjpeg" or "port"], once chosen


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found: set CXX")
    return found


def library_path(name: str) -> str:
    sources, link = LIBRARIES[name]
    h = hashlib.sha256(" ".join(CXXFLAGS + link).encode())
    for src in sources:
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(src.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libdqvq_{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library `name` unless it is built; returns its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources, link = LIBRARIES[name]
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process ends
        if os.path.exists(out):
            return out
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, "lib.so")
            cmd = [_cxx(), *CXXFLAGS, *(os.path.join(_HERE, s) for s in sources), *link,
                   "-o", tmp_so]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(f"building {', '.join(sources)} failed ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp_so, out)
        build_seconds[name] = time.perf_counter() - t0
    return out


def lib(name: str):
    """The loaded library `name`, built at its first use; a failed build
    raises again on every call."""
    with _lock:
        if name not in _loaded:
            try:
                handle = ctypes.CDLL(build(name))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _loaded[name] = RuntimeError(f"the {name} library cannot be used: {e}")
            else:
                for fn_name, argtypes in SIGNATURES[name].items():
                    fn = getattr(handle, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
                _loaded[name] = handle
        got = _loaded[name]
    if isinstance(got, RuntimeError):
        raise got
    return got


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def jpeg_backend() -> str:
    """"libjpeg" where the `jpeg` library builds and loads, else "port" (the
    `image_core` decoder); chosen once a process and printed when chosen."""
    if not _jpeg_backend:
        try:
            lib("jpeg")
            choice, why = "libjpeg", ""
        except RuntimeError as e:
            choice, why = "port", f"; libjpeg unavailable: {str(e).splitlines()[0]}"
        line = f"[dqvq native] JPEG decoder: {_describe(choice)}{why}"
        with _lock:
            if not _jpeg_backend:
                _jpeg_backend.append(choice)
                print(line, flush=True)
    return _jpeg_backend[0]


def _describe(backend: str) -> str:
    if backend == "port":
        return "the port's libjpeg-compatible decoder (native/jpeg_decoder.cpp)"
    v = jpeg_version()
    turbo = f"-turbo {v['libjpeg_turbo_version']}" if v["libjpeg_turbo_version"] else ""
    return f"libjpeg{turbo} (JPEG_LIB_VERSION {v['jpeg_lib_version']})"


def decoder_name() -> str:
    """The JPEG decoder in use: 'libjpeg-turbo 2.1.5 (JPEG_LIB_VERSION 62)',
    or the port's own decoder where libjpeg is absent."""
    return _describe(jpeg_backend())


def jpeg_header(data: bytes) -> tuple[int, int, int] | str:
    """(height, width, components), or the decoder's message for a stream it
    cannot read."""
    h, w, comps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    if jpeg_backend() == "libjpeg":
        rc = lib("jpeg").dqvq_jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                          ctypes.byref(comps), msg, len(msg))
    else:
        rc = lib("image_core").dqvq_jpeg_port_header(data, len(data), ctypes.byref(h),
                                                     ctypes.byref(w), ctypes.byref(comps), msg,
                                                     len(msg))
    return (h.value, w.value, comps.value) if rc == 0 else msg.value.decode(errors="replace")


def jpeg_port_coefficients(data: bytes) -> list[np.ndarray]:
    """The port decoder's quantised DCT coefficients of every component,
    (block rows, block columns, 64) int16 in natural order (what libjpeg's
    `jpeg_read_coefficients` gives). Raises ValueError with its message."""
    header = jpeg_header(data)
    if isinstance(header, str):
        raise ValueError(header)
    h, w, comps = header
    out = np.empty((h // 8 + 8) * (w // 8 + 8) * 64 * comps * 16, np.int16)  # to 4x4 sampling
    dims = (ctypes.c_int * 8)()
    msg = ctypes.create_string_buffer(256)
    n = lib("image_core").dqvq_jpeg_port_coefficients(data, len(data), dims, _ptr(out), out.size,
                                                      msg, len(msg))
    if n < 0:
        raise ValueError(msg.value.decode(errors="replace"))
    if n > out.size:
        raise RuntimeError(f"{n} coefficients, room for {out.size}")
    arrays, pos = [], 0
    for i in range(comps):
        rows, cols = dims[2 * i], dims[2 * i + 1]
        arrays.append(out[pos:pos + rows * cols * 64].reshape(rows, cols, 64).copy())
        pos += rows * cols * 64
    return arrays


def _decode(data, denom, space, channels, shape):
    """(array, None), or (None, the decoder's message)."""
    out = np.empty((*shape, channels), np.uint8)
    rh, rw = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    if jpeg_backend() == "libjpeg":
        jl = lib("jpeg")
        if space == 0:  # the JAX package's entry
            rc = jl.dqvq_decode_jpeg(data, len(data), denom, _ptr(out), out.nbytes,
                                     ctypes.byref(rh), ctypes.byref(rw))
        else:
            rc = jl.dqvq_decode_jpeg_full(data, len(data), space, _ptr(out), out.nbytes,
                                          ctypes.byref(rh), ctypes.byref(rw), msg, len(msg))
    else:
        rc = lib("image_core").dqvq_jpeg_port_decode(data, len(data), denom, space, _ptr(out),
                                                     out.nbytes, ctypes.byref(rh),
                                                     ctypes.byref(rw), msg, len(msg))
    if rc != 0:
        return None, f"{msg.value.decode(errors='replace') or 'decode failed'} (code {rc})"
    if (rh.value, rw.value) != tuple(shape):
        raise RuntimeError(f"JPEG decoded to {rh.value}x{rw.value}, expected {shape}")
    return out, None


def decode_jpeg(data: bytes, min_side: int | None = None) -> np.ndarray | None:
    """JPEG bytes -> (H, W, 3) uint8 RGB, as the JAX package's
    `native.decode_jpeg`: with `min_side`, libjpeg's DCT-domain downscale by
    the largest of 8, 4, 2 that keeps min(h, w) // d >= min_side. None where
    libjpeg refuses the stream (not a JPEG, or no RGB conversion: CMYK)."""
    header = jpeg_header(data)
    if isinstance(header, str):
        return None
    h, w, _ = header
    denom = 1
    if min_side:
        for d in (8, 4, 2):
            if min(h, w) // d >= min_side:
                denom = d
                break
    shape = ((h + denom - 1) // denom, (w + denom - 1) // denom)
    return _decode(data, denom, 0, 3, shape)[0]


# components -> (mode, colour space of the full decode, bytes a pixel)
_JPEG_MODES = {1: ("L", 1, 1), 3: ("RGB", 0, 3), 4: ("CMYK", 2, 4)}


def decode_jpeg_full(data: bytes) -> tuple[np.ndarray, str]:
    """JPEG bytes -> ((H, W, C) uint8, mode) at full size in the mode Pillow
    opens it in: L, RGB, or CMYK stored inverted as Pillow stores it.
    Raises ValueError with the decoder's message."""
    header = jpeg_header(data)
    if isinstance(header, str):
        raise ValueError(f"not a readable JPEG: {header}")
    h, w, comps = header
    if comps not in _JPEG_MODES:
        raise ValueError(f"a JPEG of {comps} components")
    mode, space, channels = _JPEG_MODES[comps]
    out, err = _decode(data, 1, space, channels, (h, w))
    if out is None:
        raise ValueError(f"could not decode it as {mode}: {err}")
    return out, mode


def jpeg_version() -> dict:
    """The libjpeg the `jpeg` library was built against."""
    lib_v, turbo = ctypes.c_int(), ctypes.c_int()
    lib("jpeg").dqvq_jpeg_version(ctypes.byref(lib_v), ctypes.byref(turbo))
    t = turbo.value
    return {"jpeg_lib_version": lib_v.value,
            "libjpeg_turbo_version": f"{t // 1000000}.{t // 1000 % 1000}.{t % 1000}" if t else None}


def resample(arr: np.ndarray, height: int, width: int, filter: int) -> np.ndarray:
    """(H, W, C) uint8, C 1..4 -> (height, width, C), as Pillow's
    `Image.resize((width, height), filter)` on a mode of C 8-bit bands."""
    src = np.ascontiguousarray(arr, np.uint8)
    if src.ndim != 3 or not 1 <= src.shape[2] <= 4 or height < 1 or width < 1:
        raise ValueError(f"resample: bad shape {src.shape} -> ({height}, {width})")
    dst = np.empty((height, width, src.shape[2]), np.uint8)
    rc = lib("image_core").dqvq_resample(_ptr(src), src.shape[0], src.shape[1], src.shape[2],
                                         _ptr(dst), height, width, int(filter))
    if rc != 0:
        raise ValueError(f"resample: filter {filter} or shape {src.shape} not supported")
    return dst


def png_unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG rows (a filter byte + `row_bytes` each) -> (height,
    row_bytes) uint8. Raises ValueError on short data or an unknown filter."""
    if len(raw) < height * (row_bytes + 1):  # before allocating what the header claims
        raise ValueError(f"image data too short: {len(raw)} bytes for {height} rows "
                         f"of {row_bytes}")
    out = np.empty((height, row_bytes), np.uint8)
    if lib("image_core").dqvq_png_unfilter(raw, len(raw), height, row_bytes, bpp, _ptr(out)):
        raise ValueError("unknown PNG filter type")
    return out
