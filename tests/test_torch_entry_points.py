"""The port's own sampling and serving entry points on the CPU at the tiny
stage-2 config:

* `python -m dynamicvectorquantization_torch.sample.val` (greedy: top-k 1,
  batches of 4, 8 images, grids) against the JAX package's
  `scripts/sample_val/sample_dynamic_uncond.py` `main` on the same weights,
  written here as a reference-named torch `.ckpt` that both load: the
  pickled uint8 batches equal in at least 99.9 % of values, never more than
  one step apart;
* `...sample.images`: its PNGs (decoded with PIL, which the port does not
  use) equal to those pickles;
* `python -m dynamicvectorquantization_torch.serve` (`serve/http.py`) on a
  loopback socket: `POST /generate` decodes to the sampler's images for the
  same seed, `GET /healthz`, 404 on an unknown path, 400 for `num_images`
  0 or above `max_batch`;
* without `--device` the entry points want the CUDA card, and on the card
  (`cuda` marker) `sample.val` runs there by default, with int8 caches and
  f32 queries through the decode kernel.
"""
import base64
import io
import json
import os
import pickle
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.sample import images as sample_images
from dynamicvectorquantization_torch.sample import val as sample_val
from dynamicvectorquantization_torch.serve import BatchingSampler
from dynamicvectorquantization_torch.serve import http as serve_http
from dynamicvectorquantization_torch.utils.logging import to_uint8
from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
GREEDY = ["--yaml_path", TINY, "--top_k", "1", "--top_k_pos", "1", "--batch_size", "4",
          "--sample_num", "8", "--seed", "3"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Seeded weights, the transformer perturbed from a numpy seed (greedy
    choices far from ties), as a reference-named Lightning-style `.ckpt`
    holding the quantizer's EMA statistics the JAX converter reads."""
    model, _ = load_model_and_variables(TINY, seed=0, device="cpu")
    r = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.transformer.parameters():
            p.add_(torch.from_numpy(r.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    cb = sd["first_stage_model.quantize.codebook.weight"]
    sd["first_stage_model.quantize.codebook.cluster_size_ema"] = torch.zeros(cb.shape[0] - 1)
    sd["first_stage_model.quantize.codebook.embed_ema"] = cb[:-1].clone()
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    torch.save({"state_dict": sd}, path)
    return path


def _pickles(root):
    names = sorted(os.listdir(os.path.join(root, "numpys")))
    out = []
    for name in names:
        with open(os.path.join(root, "numpys", name), "rb") as f:
            out.append(pickle.load(f))
    return names, out


@pytest.fixture(scope="module")
def port_val(ckpt, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port"))
    assert sample_val.main([*GREEDY, "--model_path", ckpt, "--save_path", root, "--save_grids",
                            "--device", "cpu"]) == 0
    return root


def test_val_pickles_match_the_jax_script(ckpt, port_val, tmp_path, monkeypatch):
    from scripts.sample_val import sample_dynamic_uncond as jscript

    monkeypatch.setattr(sys, "argv", ["sample_dynamic_uncond.py", *GREEDY, "--model_path", ckpt,
                                      "--save_path", str(tmp_path)])
    jscript.main()
    names, ref = _pickles(str(tmp_path))
    got_names, got = _pickles(port_val)
    assert got_names == names == ["batch_00000.pkl", "batch_00001.pkl"]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (4, 64, 64, 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert got[0].std() > 10  # not a blank image (greedy rows of one condition are alike)


def test_val_grids_are_pngs_of_the_first_images(port_val):
    from PIL import Image

    from dynamicvectorquantization_torch.utils.logging import make_grid

    names, batches = _pickles(port_val)
    grids = sorted(n for n in os.listdir(port_val) if n.endswith(".png"))
    assert grids == ["grid_00000.png", "grid_00001.png"]
    for name, batch in zip(grids, batches):
        with Image.open(os.path.join(port_val, name)) as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), make_grid(batch[:16]))


def test_images_entry_point_writes_the_val_images(ckpt, port_val, tmp_path, capsys):
    from PIL import Image

    assert sample_images.main([*GREEDY[:-4], "--sample_num", "6", "--seed", "3", "--model_path",
                               ckpt, "--save_path", str(tmp_path), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 6 and summary["batches"] == 2
    assert sorted(os.listdir(tmp_path)) == [f"{i:06d}.png" for i in range(6)]
    _, batches = _pickles(port_val)
    want = np.concatenate(batches)[:6]
    for i in range(6):
        with Image.open(tmp_path / f"{i:06d}.png") as im:
            assert im.mode == "RGB" and im.size == (64, 64)
            np.testing.assert_array_equal(np.asarray(im), want[i])


def test_entry_points_want_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for main in (sample_val.main, sample_images.main, serve_http.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--yaml_path", TINY, "--save_path", str(tmp_path)] if main is not serve_http.main
                 else ["--yaml_path", TINY])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_val_entry_point_runs_on_the_card_by_default(cuda_device, ckpt, tmp_path, capsys):
    from dynamicvectorquantization_torch.ops.attention import fused_attention_forward
    from dynamicvectorquantization_torch.ops.kv_int8 import decode_attention_int8

    before = decode_attention_int8.launches, fused_attention_forward.launches
    assert sample_val.main([*GREEDY, "--model_path", ckpt, "--save_path", str(tmp_path),
                            "--kv_cache_dtype", "int8"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 8 and summary["batches"] == 2
    _, batches = _pickles(str(tmp_path))
    assert [(b.shape, b.dtype) for b in batches] == [((4, 64, 64, 3), np.uint8)] * 2
    layers = 4  # 2 position + 2 content layers, one decode launch each an AR step
    launched = decode_attention_int8.launches - before[0]
    assert launched >= layers and launched % layers == 0
    assert fused_attention_forward.launches > before[1]  # the decoder's AttnBlock


# ------------------------------------------------------------------------ HTTP
@pytest.fixture(scope="module")
def server(ckpt):
    model, _ = load_model_and_variables(TINY, ckpt, device="cpu")
    with BatchingSampler(model, max_batch=3, max_wait_ms=50.0, top_k=30,
                         top_k_pos=16) as engine:
        engine.generate(1, seed=0)  # the warm-up `main` runs before it listens
        httpd = serve_http.make_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            yield engine, f"http://127.0.0.1:{httpd.server_address[1]}"
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()


_LOOPBACK = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _call(url, body=None):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    try:
        with _LOOPBACK.open(urllib.request.Request(url, data=data), timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_returns_the_samplers_images(server):
    from PIL import Image

    engine, url = server
    code, health = _call(url + "/healthz")
    assert code == 200 and health == {"ok": True, "batches_run": engine.batches_run,
                                      "images_served": engine.images_served, "max_batch": 3}
    served = health["images_served"]
    code, out = _call(url + "/generate", {"num_images": 2, "seed": 7})
    assert code == 200 and len(out["images"]) == 2 and out["batch"] == engine.batches_run
    got = [np.asarray(Image.open(io.BytesIO(base64.b64decode(s)))) for s in out["images"]]
    want = to_uint8(engine.generate(2, seed=7))
    np.testing.assert_array_equal(np.stack(got), want)
    assert want.shape == (2, 64, 64, 3)
    code, health = _call(url + "/healthz")
    assert code == 200 and health["images_served"] == served + 4


@pytest.mark.parametrize("path,body,code", [
    ("/nowhere", None, 404), ("/nowhere", {"num_images": 1}, 404),
    ("/generate", {"num_images": 0}, 400), ("/generate", {"num_images": 4}, 400),
    ("/generate", b"not json", 400)])
def test_http_refusals(server, path, body, code):
    _, url = server
    got, out = _call(url + path, body)
    assert got == code and "error" in out
