"""The port's host image pipeline (`dynamicvectorquantization_torch/native/`,
`data/image_io.py`, `data/transforms.py`) against PIL, a plain numpy
resampler and the JAX package, on the CPU, all exactly:

  * the C++ resampler (Pillow's `Resample.c` in fixed point, and the affine
    scaling Pillow's NEAREST takes) equals the numpy oracle below and
    `PIL.Image.resize`, bilinear and bicubic, on hypothesis-drawn sizes up
    and down, 1, 3 and 4 channels; the transforms' RGBA / LA (premultiplied)
    and palette (NEAREST) resizes equal Pillow's;
  * the JPEG decode equals the JAX package's `native.decode_jpeg` at every
    DCT-domain denominator (skipped where the JAX library does not build);
  * the PNG reader equals PIL for colour types 0, 2, 3, 4 and 6 and all five
    filter types (PNGs written in the test, one filter a row);
  * the committed fixtures (`tests/fixtures/images/`, made by its
    `make_fixtures.py` from seeded arrays) read and transformed by the port
    equal `expected.json`, which is recomputed here from the JAX package and
    must be current; CMYK and a PNG named `.JPEG` take the JAX package's full
    route;
  * with PIL blocked (`sys.modules["PIL"] = None`: a machine without it) the
    JPEG, RGB and L PNG routes and the transforms still give those arrays,
    and what needs PIL raises naming the file;
  * the port's own JPEG decoder (`native/jpeg_decoder.cpp`, for machines
    without libjpeg) equals libjpeg on files PIL
    writes (sizes, qualities, subsamplings, progressive, optimised tables,
    restart markers, grey, CMYK) and on files libjpeg's encoder writes in
    the colour spaces and sampling factors PIL does not (YCCK, RGB, 4:1:1,
    4:4:0), at every denominator; with it in place of libjpeg the fixtures
    still equal `expected.json`.
"""
import hashlib
import importlib.util
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamicvectorquantization_torch import native
from dynamicvectorquantization_torch.data import transforms as T
from dynamicvectorquantization_torch.data.image_io import ImageReadError, decode_image, read_image

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(_REPO, "tests", "fixtures", "images")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ the numpy oracle
def _filter(name, x):
    x = abs(x)
    if name == "bilinear":
        return 1.0 - x if x < 1.0 else 0.0
    a = -0.5
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size, out_size, name):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: per output, its
    first input and its fixed-point weights (22 fractional bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = (1.0 if name == "bilinear" else 2.0) * filterscale
    out = []
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_filter(name, (x + xmin - center + 0.5) * (1.0 / filterscale)) for x in range(xmax)]
        total = sum(w)
        w = [v / total if total != 0.0 else v for v in w]
        k = [int(-0.5 + v * (1 << 22)) if v < 0 else int(0.5 + v * (1 << 22)) for v in w]
        out.append((xmin, np.array(k, np.int64)))
    return out


def _pass(arr, out_size, name, axis):
    """One separable pass along `axis` (1: horizontal, 0: vertical)."""
    moved = np.moveaxis(arr.astype(np.int64), axis, 0)
    rows = []
    for xmin, k in _coeffs(moved.shape[0], out_size, name):
        s = (1 << 21) + np.tensordot(k, moved[xmin:xmin + len(k)], axes=(0, 0))
        rows.append(np.clip(s >> 22, 0, 255))
    return np.moveaxis(np.stack(rows), 0, axis).astype(np.uint8)


def resample_oracle(arr, oh, ow, name):
    """Pillow's 8-bit resize: horizontal pass first, each only if its size
    changes."""
    if arr.shape[1] != ow:
        arr = _pass(arr, ow, name, 1)
    if arr.shape[0] != oh:
        arr = _pass(arr, oh, name, 0)
    return arr


_MODES = {1: "L", 3: "RGB", 4: "CMYK"}  # CMYK: four bands resized as they are


def _pil_resize(arr, oh, ow, resample):
    from PIL import Image

    c = arr.shape[2]
    img = Image.fromarray(arr[..., 0] if c == 1 else arr, _MODES[c])
    out = np.asarray(img.resize((ow, oh), resample))
    return out.reshape(oh, ow, c)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), oh=st.integers(1, 90), ow=st.integers(1, 90),
       c=st.sampled_from([1, 3, 4]), name=st.sampled_from(["bilinear", "bicubic"]),
       seed=st.integers(0, 2 ** 16))
def test_resampler_equals_the_oracle_and_pil(h, w, oh, ow, c, name, seed):
    arr = np.random.default_rng(seed).integers(0, 256, size=(h, w, c), dtype=np.uint8)
    flt = native.BILINEAR if name == "bilinear" else native.BICUBIC
    got = native.resample(arr, oh, ow, flt)
    np.testing.assert_array_equal(got, resample_oracle(arr, oh, ow, name))
    np.testing.assert_array_equal(got, _pil_resize(arr, oh, ow, flt))


@pytest.mark.parametrize("shape,out", [((375, 500), (256, 341)), ((544, 768), (256, 361)),
                                        ((17, 9), (128, 64)), ((300, 200), (64, 64))])
def test_resampler_at_the_transforms_shapes(shape, out):
    """The down- and up-scales the datasets make, all three filters."""
    arr = np.random.default_rng(1).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    for flt in (native.NEAREST, native.BILINEAR, native.BICUBIC):
        np.testing.assert_array_equal(native.resample(arr, *out, flt),
                                      _pil_resize(arr, *out, flt))
    np.testing.assert_array_equal(native.resample(arr, *out, native.BICUBIC),
                                  resample_oracle(arr, *out, "bicubic"))


@pytest.mark.parametrize("mode", ["RGBA", "LA", "P", "L", "1", "CMYK"])
def test_transform_resize_follows_pillow_per_mode(mode):
    """RGBA / LA resized premultiplied, P and 1 with NEAREST whatever the
    filter, then Pillow's convert("RGB")."""
    from PIL import Image

    r = np.random.default_rng(2)
    if mode == "P":
        img = Image.fromarray(r.integers(0, 40, size=(33, 47), dtype=np.uint8), "P")
        img.putpalette(r.integers(0, 256, size=40 * 3, dtype=np.uint8).tobytes())
    elif mode == "1":
        img = Image.fromarray(r.integers(0, 2, size=(33, 47)).astype(bool))
    else:
        c = {"RGBA": 4, "LA": 2, "L": 1, "CMYK": 4}[mode]
        img = Image.fromarray(r.integers(0, 256, size=(33, 47, c), dtype=np.uint8).squeeze(),
                              mode)
    buf = io.BytesIO()
    img.save(buf, format="TIFF")  # every mode here, decoded by PIL on our side too
    ours = decode_image(buf.getvalue())
    assert ours[1] == mode
    for size in ((20, 11), (90, 70)):
        for flt in (native.BILINEAR, native.BICUBIC):
            ref = np.asarray(img.resize(size, flt).convert("RGB"))
            np.testing.assert_array_equal(T.to_rgb(T.resize(ours, size, flt)), ref)


# ------------------------------------------------------------------- JPEG
def test_jpeg_decode_equals_the_jax_packages_at_every_denominator():
    from dynamicvectorquantization_tpu import native as jnative

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native JPEG library does not build here")
    from PIL import Image

    src = _make_fixtures().seeded_image(11, 520, 700)
    for sub in (0, 1, 2):
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, format="JPEG", quality=88, subsampling=sub)
        data = buf.getvalue()
        shapes = set()
        for min_side in (None, 300, 260, 130, 65):  # denominators 1, 1, 2, 4, 8
            ours, theirs = native.decode_jpeg(data, min_side), jnative.decode_jpeg(data, min_side)
            np.testing.assert_array_equal(ours, theirs)
            shapes.add(ours.shape)
        assert shapes == {(520, 700, 3), (260, 350, 3), (130, 175, 3), (65, 88, 3)}
    assert native.decode_jpeg(b"not a jpeg") is None


def test_full_jpeg_route_takes_pillows_modes():
    from PIL import Image

    r = np.random.default_rng(3)
    for mode, shape in (("L", (40, 30)), ("RGB", (40, 30, 3)), ("CMYK", (40, 30, 4))):
        buf = io.BytesIO()
        Image.fromarray(r.integers(0, 256, size=shape, dtype=np.uint8), mode).save(
            buf, format="JPEG", quality=90)
        arr, got_mode = decode_image(buf.getvalue())
        ref = Image.open(io.BytesIO(buf.getvalue()))
        assert got_mode == ref.mode == mode
        np.testing.assert_array_equal(arr.reshape(np.asarray(ref).shape), np.asarray(ref))
    with pytest.raises(ImageReadError, match="broken.jpg"):
        decode_image(b"\xff\xd8\xff\xe0" + b"\x00" * 40, "broken.jpg")


# -------------------------------------------------------------------- PNG
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_rows(rows, bpp, ftype):
    """Rows (h, n) uint8 -> PNG scanlines of filter type `ftype`."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        line = []
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            line.append((v - pred) & 255)
        out += bytes([ftype]) + bytes(line)
        prev = row
    return bytes(out)


def _png(arr, ctype, ftype, palette=None):
    h, w = arr.shape[:2]
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    raw = _filtered_rows(arr.reshape(h, w * spp), spp, ftype)
    half = len(raw) // 2  # two IDAT chunks, as large files have
    z = zlib.compress(raw)
    body += chunk(b"IDAT", z[:half]) + chunk(b"IDAT", z[half:]) + chunk(b"IEND", b"")
    return b"\x89PNG\r\n\x1a\n" + body


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_reader_equals_pil_for_every_colour_type_and_filter(ctype):
    from PIL import Image

    r = np.random.default_rng(ctype)
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = r.integers(0, 256, size=(16, 3), dtype=np.uint8) if ctype == 3 else None
    arr = r.integers(0, 16 if ctype == 3 else 256, size=(9, 13, spp), dtype=np.uint8)
    for ftype in range(5):
        data = _png(arr, ctype, ftype, palette)
        ours, mode = decode_image(data)
        ref = Image.open(io.BytesIO(data))
        assert mode == ref.mode
        want = np.asarray(ref.convert("RGB") if mode == "P" else ref)
        np.testing.assert_array_equal(ours.reshape(want.shape), want)
    with pytest.raises(ImageReadError, match="CRC"):
        decode_image(data[:50] + bytes([data[50] ^ 1]) + data[51:])


def test_png_without_pil_reads_8_bit_files_and_names_the_rest(monkeypatch, tmp_path):
    from PIL import Image

    r = np.random.default_rng(4)
    deep = tmp_path / "deep.png"
    Image.fromarray(r.integers(0, 65535, size=(6, 5), dtype=np.uint16)).save(deep)
    bmp = tmp_path / "x.bmp"
    Image.fromarray(r.integers(0, 256, size=(6, 5, 3), dtype=np.uint8)).save(bmp)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for path, why in ((deep, "16 bits"), (bmp, "neither a JPEG nor a PNG")):
        with pytest.raises(ImageReadError, match=why) as err:
            read_image(str(path))
        assert str(path) in str(err.value) and "PIL" in str(err.value)
    arr, mode = decode_image(_png(r.integers(0, 256, size=(4, 7, 3), dtype=np.uint8), 2, 4))
    assert mode == "RGB" and arr.shape == (4, 7, 3)


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def test_expected_json_is_current(expected):
    """Every entry recomputed from the JAX package (and every file listed)."""
    from dynamicvectorquantization_tpu import native as jnative

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native JPEG library does not build here")
    mf = _make_fixtures()
    assert expected["files"] == mf.expected_entries()
    assert (expected["seed"], expected["sizes"], expected["transforms"]) == \
        (mf.SEED, list(mf.SIZES), list(mf.TRANSFORMS))
    sizes = [os.path.getsize(os.path.join(FIXTURES, n)) for n in mf.fixture_names()]
    assert len(sizes) == 11 and sum(sizes) < 400_000


def _digest(arr):
    arr = np.ascontiguousarray(arr)
    return hashlib.sha256(arr.tobytes()).hexdigest(), \
        arr.reshape(-1, arr.shape[-1]).sum(0, dtype=np.float64).tolist()


def _check_fixtures(expected):
    """The port's decode and transforms of every fixture against the JSON."""
    for name, entry in expected["files"].items():
        for size in expected["sizes"]:
            arr, mode = read_image(os.path.join(FIXTURES, name), min_side=size)
            want = entry[f"decoded_{size}"]
            assert mode == want["mode"], name
            assert list(arr.shape[:len(want["shape"])]) == want["shape"], name
            assert _digest(arr)[0] == want["sha256"], (name, size)
            for t in expected["transforms"]:
                out = getattr(T, t)((arr, mode), size, np.random.default_rng(expected["seed"]))
                sha, sums = _digest(out)
                assert out.dtype == np.float32 and out.shape == (size, size, 3)
                assert sha == entry[f"{t}_{size}"]["sha256"], (name, size, t)
                assert sums == entry[f"{t}_{size}"]["channel_sums"]


def test_fixtures_equal_the_jax_packages_arrays(expected):
    modes = {e["decoded_256"]["mode"] for e in expected["files"].values()}
    assert modes == {"RGB", "L", "CMYK"}  # the JPEG route, the L PNG, CMYK
    _check_fixtures(expected)


def test_fixtures_without_pil(expected, monkeypatch):
    """A machine without PIL: every fixture is a JPEG or an 8-bit PNG, so all
    of them still read, to the same arrays."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    _check_fixtures(expected)


def test_libraries_are_built_once_under_build(tmp_path, monkeypatch):
    path = native.build("image_core")
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)
    assert native.build("image_core") == path
    assert native.library_path("image_core") != native.library_path("jpeg")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build("image_core")
    assert "libjpeg" in native.decoder_name()


def test_concurrent_reads_equal_serial_ones():
    """The loader's worker threads share the libraries (ctypes calls release
    the GIL): more threads than cores, a short switch interval, every array
    as a serial read's."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(n for n in os.listdir(FIXTURES) if not n.endswith((".py", ".json")))
    jobs = [(os.path.join(FIXTURES, n), size) for n in names for size in (256, 64)] * 4
    serial = {job: read_image(*job)[0].tobytes() for job in set(jobs)}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            got = list(pool.map(lambda job: read_image(*job)[0].tobytes(), jobs, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == [serial[job] for job in jobs]


# ------------------------------------------------ the port's JPEG decoder
def _decodes(data, backend):
    """Every decode of `data` through one backend: the RGB route at each
    DCT-domain denominator, and the full route (or its error)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "_jpeg_backend", [backend])
    try:
        out = [native.decode_jpeg(data, min_side) for min_side in (None, 64, 32, 16, 8)]
        try:
            out.append(native.decode_jpeg_full(data))
        except ValueError:
            out.append("refused")
    finally:
        mp.undo()
    return out


def _both_backends(data):
    """libjpeg's decodes of `data` equal the port decoder's."""
    ours, theirs = _decodes(data, "port"), _decodes(data, "libjpeg")
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(b, tuple):
            assert a[1] == b[1]
            a, b = a[0], b[0]
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a is b or a == b


def _photo(r, h, w, c):
    low = r.integers(0, 256, size=(max(h // 16, 2), max(w // 16, 2), c), dtype=np.uint8)
    px = native.resample(low, h, w, native.BICUBIC).astype(np.int16)
    return np.clip(px + r.integers(-20, 21, size=px.shape), 0, 255).astype(np.uint8)


def test_port_jpeg_decoder_equals_libjpeg_on_pil_files():
    from PIL import Image

    r = np.random.default_rng(21)
    for i in range(48):
        h, w = (int(v) for v in r.integers(1, 200, size=2))
        kind = ("RGB", "L", "CMYK")[i % 3] if i % 4 else "RGB"
        arr = _photo(r, h, w, {"RGB": 3, "L": 1, "CMYK": 4}[kind])
        kw = {"quality": int(r.integers(30, 100)), "progressive": bool(i % 5 == 1),
              "optimize": bool(i % 7 == 2)}
        if kind == "RGB":
            kw["subsampling"] = i % 3
        if i % 6 == 3:
            kw["restart_marker_blocks"] = int(r.integers(1, 9))
        buf = io.BytesIO()
        Image.fromarray(arr[..., 0] if kind == "L" else arr, kind).save(buf, "JPEG", **kw)
        _both_backends(buf.getvalue())
    for name in sorted(os.listdir(FIXTURES)):
        if name.lower().endswith((".jpg", ".jpeg")):
            with open(os.path.join(FIXTURES, name), "rb") as f:
                _both_backends(f.read())


_ENCODER = r"""
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <jpeglib.h>
extern "C" long encode(const uint8_t* px, int h, int w, int comps, int in_space, int space,
                       const int* hs, const int* vs, int quality, int progressive, int restart,
                       uint8_t* out, long cap, int arith, int dac) {
  jpeg_compress_struct c; jpeg_error_mgr e;
  c.err = jpeg_std_error(&e); jpeg_create_compress(&c);
  unsigned char* mem = nullptr; unsigned long size = 0; jpeg_mem_dest(&c, &mem, &size);
  c.image_width = w; c.image_height = h; c.input_components = comps;
  c.in_color_space = (J_COLOR_SPACE)in_space; jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)space);
  for (int i = 0; i < c.num_components; ++i) {
    c.comp_info[i].h_samp_factor = hs[i]; c.comp_info[i].v_samp_factor = vs[i];
  }
  jpeg_set_quality(&c, quality, TRUE);
  if (progressive) jpeg_simple_progression(&c);
  c.restart_interval = restart;
  c.arith_code = arith ? TRUE : FALSE;
  for (int i = 0; dac && i < NUM_ARITH_TBLS; ++i) {  // conditioning other than the defaults
    c.arith_dc_L[i] = 1; c.arith_dc_U[i] = 3; c.arith_ac_K[i] = 2;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(px + (long)c.next_scanline * w * comps);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c); jpeg_destroy_compress(&c);
  long n = (long)size <= cap ? (long)size : -1;
  for (long i = 0; i < n; ++i) out[i] = mem[i];
  free(mem);
  return n;
}
extern "C" long coefficients(const uint8_t* buf, long len, int16_t* out, long cap) {
  jpeg_decompress_struct c; jpeg_error_mgr e;
  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);
  jpeg_mem_src(&c, buf, len); jpeg_read_header(&c, TRUE);
  jvirt_barray_ptr* arrays = jpeg_read_coefficients(&c);
  long n = 0;
  for (int ci = 0; ci < c.num_components; ++ci) {
    jpeg_component_info* comp = &c.comp_info[ci];
    for (JDIMENSION by = 0; by < comp->height_in_blocks; ++by) {
      JBLOCKARRAY row = c.mem->access_virt_barray((j_common_ptr)&c, arrays[ci], by, 1, FALSE);
      for (JDIMENSION bx = 0; bx < comp->width_in_blocks; ++bx, n += 64)
        for (int k = 0; n + 64 <= cap && k < 64; ++k) out[n + k] = row[0][bx][k];
    }
  }
  jpeg_finish_decompress(&c); jpeg_destroy_decompress(&c);
  return n;
}
"""


def libjpeg_encoder(workdir):
    """`encode(px, space, in_space, hs, vs, quality, progressive, restart,
    arith=0, dac=0) -> bytes` through libjpeg's own encoder, built in
    `workdir` from `_ENCODER`; None where libjpeg's headers are absent."""
    import ctypes
    import subprocess

    src, so = os.path.join(workdir, "encode.cpp"), os.path.join(workdir, "libencode.so")
    with open(src, "w") as f:
        f.write(_ENCODER)
    proc = subprocess.run(["g++", "-O1", "-shared", "-fPIC", src, "-ljpeg", "-o", so],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        return None
    enc = ctypes.CDLL(so)
    p = ctypes.c_void_p
    enc.encode.restype = ctypes.c_long
    enc.encode.argtypes = (p, *(ctypes.c_int,) * 5, p, p, *(ctypes.c_int,) * 3, p,
                           ctypes.c_long, ctypes.c_int, ctypes.c_int)

    def encode(px, space, in_space, hs, vs, quality, progressive, restart, arith=0, dac=0):
        px = np.ascontiguousarray(px)
        h, w = px.shape[:2]
        comps = 1 if px.ndim == 2 else px.shape[2]
        hs_a, vs_a = np.array(hs, np.int32), np.array(vs, np.int32)
        out = np.empty(4_000_000, np.uint8)
        n = enc.encode(px.ctypes.data_as(p), h, w, comps, in_space, space,
                       hs_a.ctypes.data_as(p), vs_a.ctypes.data_as(p), quality, progressive,
                       restart, out.ctypes.data_as(p), out.nbytes, arith, dac)
        assert n > 0
        return out[:n].tobytes()

    enc.coefficients.restype = ctypes.c_long
    enc.coefficients.argtypes = (ctypes.c_char_p, ctypes.c_long, p, ctypes.c_long)

    def coefficients(data):
        """libjpeg's quantised coefficients of every component, concatenated."""
        out = np.empty(4_000_000, np.int16)
        n = enc.coefficients(data, len(data), out.ctypes.data_as(p), out.size)
        return out[:n]

    encode.coefficients = coefficients
    return encode


def pil_libjpeg_decoder(workdir):
    """`decode(data, denominator) -> (H, W, 3) uint8 RGB, or None where it
    refuses the data`: the libjpeg-turbo that PIL bundles (its wheel's
    `pillow.libs/libjpeg-*.so*`; 3.1.3 with PIL 12.1.0) through a memory
    source that supplies a fake EOI past the data, as the JAX package's
    libjpeg route reads; `native/host_pipeline.cpp` built in `workdir`
    against libjpeg's headers and that library. PIL's own reader cannot
    stand in for it on cut arithmetic-coded files: it reads through a
    suspending source, in which libjpeg's arithmetic decoder stops with an
    error. None where PIL bundles no libjpeg or nothing builds."""
    import ctypes
    import glob
    import subprocess

    import PIL
    import PIL.features

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                   "pillow.libs", "libjpeg-*.so*"))
    if len(found) != 1:
        return None
    so = os.path.join(workdir, "libpil_jpeg.so")
    src = os.path.join(_REPO, "dynamicvectorquantization_torch", "native", "host_pipeline.cpp")
    proc = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-std=c++17", src, found[0],
                           "-o", so, f"-Wl,-rpath,{os.path.dirname(found[0])}"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        return None
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dqvq_decode_jpeg.argtypes = (ctypes.c_char_p, ctypes.c_long, i, p, ctypes.c_long,
                                     ctypes.POINTER(i), ctypes.POINTER(i))

    def decode(data, denom):
        header = native.jpeg_header(data)
        if isinstance(header, str):
            return None
        h, w, _ = header
        out = np.empty((-(-h // denom), -(-w // denom), 3), np.uint8)
        rh, rw = i(), i()
        rc = lib.dqvq_decode_jpeg(data, len(data), denom, out.ctypes.data_as(p), out.nbytes,
                                  ctypes.byref(rh), ctypes.byref(rw))
        return None if rc else out

    decode.version = PIL.features.version_feature("libjpeg_turbo")
    return decode


@pytest.fixture(scope="module")
def pil_libjpeg(tmp_path_factory):
    decode = pil_libjpeg_decoder(str(tmp_path_factory.mktemp("pil_libjpeg")))
    if decode is None:
        pytest.skip("PIL bundles no libjpeg-turbo here, or libjpeg's headers are absent")
    return decode


def _port_rgb(data, denom, backend="port"):
    """The port decoder's (or `backend`'s) RGB array at 1/denom, or None
    where it refuses the data."""
    header = native.jpeg_header(data)
    if isinstance(header, str):
        return None
    h, w, _ = header
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "_jpeg_backend", [backend])
    try:
        return native._decode(data, denom, 0, 3, (-(-h // denom), -(-w // denom)))[0]
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    enc = libjpeg_encoder(str(tmp_path_factory.mktemp("libjpeg_encoder")))
    if enc is None:
        pytest.skip("libjpeg's encoder does not build here")
    return enc


GRAY, RGB, YCC, CMYK, YCCK = 1, 2, 3, 4, 5  # J_COLOR_SPACE


def test_port_jpeg_decoder_equals_libjpeg_on_other_colour_spaces_and_samplings(encoder):
    """YCCK (Photoshop's CMYK), Adobe RGB, 4:1:1, 4:4:0 and chroma sampled
    above luma, written by libjpeg's own encoder (built here; skipped where
    libjpeg's headers are absent)."""
    gray, rgb, ycc, cmyk, ycck = GRAY, RGB, YCC, CMYK, YCCK
    r = np.random.default_rng(22)
    cases = [(ycck, cmyk, 4, (2, 1, 1, 2), (2, 1, 1, 2)), (ycck, cmyk, 4, (1, 1, 1, 1), (1,) * 4),
             (cmyk, cmyk, 4, (2, 1, 1, 1), (1,) * 4), (rgb, rgb, 3, (1, 1, 1), (1, 1, 1)),
             (ycc, rgb, 3, (4, 1, 1), (1, 1, 1)), (ycc, rgb, 3, (1, 1, 1), (2, 1, 1)),
             (ycc, rgb, 3, (1, 2, 2), (1, 1, 1)), (ycc, rgb, 3, (2, 1, 1), (4, 1, 1)),
             (gray, gray, 1, (1,), (1,))]
    for i, (space, in_space, comps, hs, vs) in enumerate(cases * 3):
        h, w = (int(v) for v in r.integers(1, 150, size=2))
        px = _photo(r, h, w, comps)
        _both_backends(encoder(px, space, in_space, hs, vs, int(r.integers(40, 98)), i % 2,
                               int(i % 4 == 3) * 2))


# arithmetic coding (SOF9 / SOF10): every layout, sequential and progressive,
# with and without restart intervals, at every denominator and the full route
ARITH_LAYOUTS = {"420": (YCC, RGB, 3, (2, 1, 1), (2, 1, 1)),
                 "444": (YCC, RGB, 3, (1, 1, 1), (1, 1, 1)),
                 "gray": (GRAY, GRAY, 1, (1,), (1,)),
                 "cmyk": (CMYK, CMYK, 4, (1, 1, 1, 1), (1, 1, 1, 1)),
                 "ycck": (YCCK, CMYK, 4, (2, 1, 1, 2), (2, 1, 1, 2))}


@pytest.mark.parametrize("layout", sorted(ARITH_LAYOUTS))
def test_port_jpeg_decoder_equals_libjpeg_on_arithmetic_files(encoder, layout):
    space, in_space, comps, hs, vs = ARITH_LAYOUTS[layout]
    r = np.random.default_rng(sorted(ARITH_LAYOUTS).index(layout) + 40)
    for progressive in (0, 1):
        for restart in (0, 1, 3):
            h, w = (int(v) for v in r.integers(1, 130, size=2))
            data = encoder(_photo(r, h, w, comps), space, in_space, hs, vs,
                           int(r.integers(40, 98)), progressive, restart, arith=1,
                           dac=int(restart == 3))
            assert data[2:].find(b"\xff\xc9" if not progressive else b"\xff\xca") >= 0
            _both_backends(data)


@pytest.mark.parametrize("progressive", [0, 1])
def test_port_jpeg_decoder_equals_libjpeg_on_a_truncated_arithmetic_file(encoder, progressive):
    """The rest of a cut scan decodes from zero data, with a warning and no
    error, as libjpeg's: the quantised coefficients equal
    `jpeg_read_coefficients`'s at every cut, and the file without its EOI
    marker decodes to libjpeg's pixels. The pixels at every cut are held to
    PIL's libjpeg-turbo by `test_cut_files_decode_to_pils_libjpeg_turbo`."""
    r = np.random.default_rng(47 + progressive)
    data = encoder(_photo(r, 96, 120, 3), YCC, RGB, (2, 1, 1), (2, 1, 1), 85, progressive, 0,
                   arith=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "_jpeg_backend", ["port"])
    try:
        for frac in (0.3, 0.6, 0.95):
            cut = data[:int(len(data) * frac)]
            np.testing.assert_array_equal(
                np.concatenate([c.ravel() for c in native.jpeg_port_coefficients(cut)]),
                encoder.coefficients(cut))
    finally:
        mp.undo()
    _both_backends(data[:len(data) - 2])


CUT_LAYOUTS = {"420": (YCC, RGB, 3, (2, 1, 1), (2, 1, 1)),
               "422": (YCC, RGB, 3, (2, 1, 1), (1, 1, 1)), "gray": (GRAY, GRAY, 1, (1,), (1,))}


@pytest.mark.parametrize("arith", [0, 1], ids=["huffman", "arithmetic"])
@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
def test_cut_files_decode_to_pils_libjpeg_turbo(encoder, pil_libjpeg, arith, progressive,
                                               monkeypatch):
    """F13: files cut at 0.3, 0.6 and 0.95 of their length decode, at every
    DCT-domain denominator, to the pixels of the libjpeg-turbo that PIL
    bundles (or are refused where it refuses them): its block smoothing of a
    progressive image whose later scans are missing (jdcoefct.c
    decompress_smooth_data, with the progression status before the cut scan
    past its last good iMCU row), the Huffman decoder leaving the rest of a
    segment alone once its data ran out, and its x86 SIMD IDCTs' integer
    widths on the out-of-range coefficients that zero data decodes to. For
    Huffman files PIL's own reader gives the same pixels, except where its
    suspending source stops the decode and leaves a blank image (a cut
    progressive file with restart markers, here); for arithmetic ones it
    cannot decode a cut file at all. Where the system libjpeg agrees with
    PIL's, the port agrees with both; on cut progressive files they often
    differ (another libjpeg-turbo version)."""
    from PIL import Image, ImageFile

    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    r = np.random.default_rng(70 + 2 * arith + progressive)
    compared = refused = system_agrees = pil_reader_equal = 0
    for layout, (space, in_space, comps, hs, vs) in sorted(CUT_LAYOUTS.items()):
        for restart in (0, 2):
            h, w = (int(v) for v in r.integers(64, 130, size=2))
            px = _photo(r, h, w, comps)
            data = encoder(px if comps > 1 else px[..., 0], space, in_space, hs, vs,
                           int(r.integers(50, 95)), progressive, restart, arith=arith)
            for fraction in (0.3, 0.6, 0.95):
                cut = data[:int(len(data) * fraction)]
                for d in (1, 2, 4, 8):
                    want, got = pil_libjpeg(cut, d), _port_rgb(cut, d)
                    if want is None:
                        assert got is None, (layout, restart, fraction, d)
                        refused += 1
                        continue
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{layout} restart {restart} cut {fraction} 1/{d}")
                    if not arith:
                        im = Image.open(io.BytesIO(cut))
                        im.draft("RGB", (max(w // d, 1), max(h // d, 1)))
                        read = np.asarray(im.convert("RGB"))
                        assert np.array_equal(read, want) or not read.any()
                        pil_reader_equal += np.array_equal(read, want)
                    theirs = _port_rgb(cut, d, "libjpeg")
                    system_agrees += theirs is not None and np.array_equal(theirs, want)
                    compared += 1
    assert compared >= 60 and system_agrees >= compared // 4, (compared, refused,
                                                               system_agrees)
    assert arith or pil_reader_equal >= 0.9 * compared, (pil_reader_equal, compared)


def test_expected_cut_json_is_current(pil_libjpeg):
    mf = _make_fixtures()
    with open(os.path.join(FIXTURES, "expected_cut.json")) as f:
        doc = json.load(f)
    assert doc["libjpeg_turbo"] == pil_libjpeg.version
    assert doc["files"] == mf.expected_cut_entries(pil_libjpeg)


def test_cut_fixtures_through_the_port_decoder():
    """The port decoder against `expected_cut.json` (PIL's libjpeg-turbo), as
    `chip_smoke.py`'s `data_real` phase checks it on the card."""
    mf = _make_fixtures()
    with open(os.path.join(FIXTURES, "expected_cut.json")) as f:
        doc = json.load(f)
    got = mf.expected_cut_entries(_port_rgb)
    assert got == doc["files"]
    assert sum(v == "refused" for e in got.values() for v in e.values()) < len(got)


def test_lossless_arithmetic_process_is_refused_in_hex(encoder, tmp_path, monkeypatch):
    """SOF11 (lossless, arithmetic): libjpeg's message, the marker in hex;
    `read_image` names the file."""
    data = bytearray(encoder(_photo(np.random.default_rng(48), 16, 16, 3), YCC, RGB, (1, 1, 1),
                             (1, 1, 1), 85, 0, 0, arith=1))
    data[data.index(b"\xff\xc9") + 1] = 0xCB
    message = "Unsupported JPEG process: SOF type 0xcb"
    for backend in ("libjpeg", "port"):
        monkeypatch.setattr(native, "_jpeg_backend", [backend])
        assert native.jpeg_header(bytes(data)) == message
    path = tmp_path / "lossless.jpg"
    path.write_bytes(bytes(data))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImageReadError, match=f"{path}.*{message}"):
        read_image(str(path))


def test_fixtures_through_the_port_decoder(expected, monkeypatch):
    """A machine without libjpeg and without PIL."""
    monkeypatch.setattr(native, "_jpeg_backend", ["port"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert "jpeg_decoder.cpp" in native.decoder_name()
    _check_fixtures(expected)
