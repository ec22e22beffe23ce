"""Writes the image fixtures of this directory and their `expected.json`.

    JAX_PLATFORMS=cpu python tests/fixtures/images/make_fixtures.py

The files are encoded with PIL from seeded arrays (smooth fields with a
little texture, so they compress as photographs do); the two arithmetic-coded
JPEGs by libjpeg's own encoder, built as `tests/test_torch_image_io.py`
builds it. `expected.json` holds,
for each file, the sha256 and per-channel sums (float64) of what the JAX
package makes of it: the decoded array of `FileListDataset._open` (its
libjpeg decode with DCT-domain downscale, or PIL) and the outputs of
`imagenet_train_transform`, `imagenet_val_transform`, `ffhq_train_transform`
and `ffhq_val_transform`, at each size of `SIZES`, every random transform
with a fresh `numpy.random.default_rng(SEED)`. `tests/test_torch_image_io.py`
recomputes it (`expected_entries`) and holds the port to it; on the card,
`chip_smoke.py`'s `data_real` phase holds the port to the file.

`expected_cut.json` holds what the libjpeg-turbo that PIL bundles (read
through a memory source, `tests/test_torch_image_io.py` `pil_libjpeg_decoder`)
makes of four of the JPEGs cut short at each of `CUT_FRACTIONS` of their
length, at each DCT-domain denominator: the digest of the RGB array, or
"refused". `--cut` writes that file alone (it needs PIL and libjpeg's headers,
not the JAX package).

Needs PIL, the JAX package (whose native JPEG library must build) and libjpeg's
headers.
"""
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = (256, 64)
SEED = 0
TRANSFORMS = ("imagenet_train_transform", "imagenet_val_transform", "ffhq_train_transform",
              "ffhq_val_transform")


def seeded_image(seed, h, w, channels=3, noise=6.0):
    """(h, w, channels) uint8: a few low-frequency waves, two rectangles and
    mild noise (standard deviation `noise`)."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((h, w, channels))
    for c in range(channels):
        for _ in range(4):
            fy, fx = r.uniform(0.5, 6, size=2) / np.array([h, w])
            out[..., c] += r.uniform(20, 50) * np.sin(2 * np.pi * (fy * y + fx * x)
                                                      + r.uniform(0, 2 * np.pi))
    for _ in range(2):
        y0, x0 = r.integers(0, h // 2), r.integers(0, w // 2)
        out[y0:y0 + h // 3, x0:x0 + w // 3] += r.uniform(-60, 60, size=channels)
    out += 128 + r.normal(0, noise, size=out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def write_fixtures():
    """name -> how it was written; the files land in this directory."""
    from PIL import Image

    def rgb(seed, h, w, noise=6.0):
        return Image.fromarray(seeded_image(seed, h, w, noise=noise))

    made = {}

    def save(name, img, **kw):
        img.save(os.path.join(HERE, name), **kw)
        made[name] = f"{img.mode} {img.size[0]}x{img.size[1]} {kw}"

    # ImageNet's typical file: 500 x 375, 4:2:0, quality 90
    save("n01_rgb420_q90.JPEG", rgb(1, 375, 500), format="JPEG", quality=90, subsampling=2)
    save("rgb444_q85.jpg", rgb(2, 240, 320), format="JPEG", quality=85, subsampling=0)
    save("gray_q90.jpg", Image.fromarray(seeded_image(3, 400, 300, 1)[..., 0]), format="JPEG",
         quality=90)
    save("progressive_q80.jpeg", rgb(4, 300, 400), format="JPEG", quality=80, progressive=True)
    # short side 544: DCT-domain downscale by 2 at size 256, by 8 at 64
    save("large_q75.jpg", rgb(5, 544, 768), format="JPEG", quality=75)
    # Adobe CMYK (Pillow writes the Adobe marker and inverted values)
    save("cmyk_q90.jpg", Image.fromarray(seeded_image(6, 240, 320, 4, noise=2.0), "CMYK"),
         format="JPEG", quality=90)
    # ImageNet holds PNG files named .JPEG
    # PNGs keep little noise, which PNG cannot compress
    save("png_named.JPEG", rgb(7, 120, 180, noise=1.0), format="PNG")
    save("rgb.png", rgb(8, 150, 220, noise=1.0), format="PNG")
    save("gray.png", Image.fromarray(seeded_image(9, 300, 200, 1, noise=1.0)[..., 0]),
         format="PNG")
    # arithmetic coding (PIL cannot ask for it): libjpeg's own encoder, 4:2:0,
    # sequential (SOF9) and progressive with a restart every 2 MCUs (SOF10)
    import tempfile

    from tests.test_torch_image_io import RGB, YCC, libjpeg_encoder

    with tempfile.TemporaryDirectory() as tmp:
        encode = libjpeg_encoder(tmp)
        if encode is None:
            raise RuntimeError("libjpeg's encoder does not build here")
        for name, seed, (h, w), quality, progressive, restart in (
                ("arith_q85.jpg", 10, (180, 240), 85, 0, 0),
                ("arith_progressive_rst_q80.jpg", 11, (150, 200), 80, 1, 2)):
            with open(os.path.join(HERE, name), "wb") as f:
                f.write(encode(seeded_image(seed, h, w), YCC, RGB, (2, 1, 1), (2, 1, 1), quality,
                               progressive, restart, arith=1))
            made[name] = (f"RGB {w}x{h} libjpeg arith_code quality {quality} 4:2:0 progressive "
                          f"{bool(progressive)} restart_interval {restart}")
    return made


def fixture_names():
    return sorted(n for n in os.listdir(HERE) if not n.endswith((".py", ".json"))
                  and not n.startswith("."))


def digest(arr):
    arr = np.ascontiguousarray(arr)
    sums = arr.reshape(-1, arr.shape[-1] if arr.ndim == 3 else 1).sum(0, dtype=np.float64)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "channel_sums": [float(s) for s in sums]}


def expected_entries():
    """{file: {"decoded_<size>": digest, "<transform>_<size>": digest}} from
    the JAX package."""
    from dynamicvectorquantization_tpu import native
    from dynamicvectorquantization_tpu.data import transforms as JT
    from dynamicvectorquantization_tpu.data.datasets import FileListDataset

    if native.get_lib() is None:
        raise RuntimeError("the JAX package's native JPEG library does not build here")
    out = {}
    for name in fixture_names():
        entry = {}
        for size in SIZES:
            ds = FileListDataset([os.path.join(HERE, name)], size=size)
            with ds._open(ds.files[0]) as img:
                entry[f"decoded_{size}"] = dict(digest(np.asarray(img)), mode=img.mode)
                for t in TRANSFORMS:
                    entry[f"{t}_{size}"] = digest(
                        getattr(JT, t)(img, size, np.random.default_rng(SEED)))
        out[name] = entry
    return out


# JPEGs cut short: baseline and progressive, Huffman and arithmetic coding
CUT_FILES = ("n01_rgb420_q90.JPEG", "progressive_q80.jpeg", "arith_q85.jpg",
             "arith_progressive_rst_q80.jpg")
CUT_FRACTIONS = (0.3, 0.6, 0.95)
CUT_DENOMINATORS = (1, 2, 4, 8)


def cut_short(data: bytes, fraction: float) -> bytes:
    return data[:int(len(data) * fraction)]


def expected_cut_entries(decode):
    """{"<file>@<fraction>": {"<denominator>": digest, or "refused"}} of
    `decode(data, denominator)` (an RGB array, or None) over the cut files."""
    out = {}
    for name in CUT_FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            data = f.read()
        for fraction in CUT_FRACTIONS:
            entry = {}
            for d in CUT_DENOMINATORS:
                arr = decode(cut_short(data, fraction), d)
                entry[str(d)] = "refused" if arr is None else digest(arr)
            out[f"{name}@{fraction}"] = entry
    return out


def write_expected_cut():
    import tempfile

    from tests.test_torch_image_io import pil_libjpeg_decoder

    with tempfile.TemporaryDirectory() as tmp:
        decode = pil_libjpeg_decoder(tmp)
        if decode is None:
            raise RuntimeError("PIL's bundled libjpeg-turbo or libjpeg's headers are absent")
        doc = {"libjpeg_turbo": decode.version, "fractions": list(CUT_FRACTIONS),
               "denominators": list(CUT_DENOMINATORS), "files": expected_cut_entries(decode)}
    with open(os.path.join(HERE, "expected_cut.json"), "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if sys.argv[1:] == ["--cut"]:
        write_expected_cut()
        return
    made = write_fixtures()
    doc = {"seed": SEED, "sizes": list(SIZES), "transforms": list(TRANSFORMS),
           "generator": f"numpy.random.default_rng({SEED}), fresh for each file, transform "
                        "and size",
           "made_with": made, "files": expected_entries()}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    write_expected_cut()
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in fixture_names())
    print(f"{len(made)} files, {total} bytes")


if __name__ == "__main__":
    main()
