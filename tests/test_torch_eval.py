"""Evaluation in the PyTorch port against the JAX package, on the CPU: the
Frechet distance (the port's two-`eigh` trace against the JAX function's
scipy `sqrtm`: relative 1e-6 with more samples than dimensions; with fewer,
where the covariances are singular and `sqrtm` is ill-conditioned, 1e-5 of
the value, 8e-9 measured at 40 samples in 64 dimensions),
`compute_statistics` and the proxy features (equal), the InceptionV3 copy
(atol 1e-5 on one seeded state_dict, features through the same
preprocessing) and its strict loading, `compute_fid` on two seeded `.pkl`
dumps (the JAX script's printed value, relative 1e-5), `rfid` and
`codebook_usage` on the tiny dual-entropy config with shared weights (codes
equal, reconstructions within 1e-4, the JAX script's printed usage and
entropy), `codebook_pca` (the JAX script's explained variance, 1e-6; a PNG
written without PIL), and `parity_report` on stand-ins (the JAX report's
legs, statuses and reasons; `variant` present), plus its `sample_fid` leg
through a `sample.val` process at the tiny stage-2 config.

JAX, scipy, PIL and the JAX package's scripts are imported inside the tests.
"""
import importlib.util
import io
import json
import os
import pickle
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.eval import (
    codebook_pca,
    codebook_usage,
    compute_fid,
    fid,
    parity_report,
)
from dynamicvectorquantization_torch.eval.inception import (
    InceptionV3,
    load_inception,
    seeded_state_dict,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DQVAE_TINY = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
STAGE2_TINY = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that on a loaded
    machine (several test processes) no small op waits at an OpenMP barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """A JAX-package script of `scripts/tools/` as a module."""
    path = os.path.join(_REPO, "scripts", "tools", f"{name}.py")
    tools = os.path.dirname(path)
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, argv0="script"):
    """stdout of `main(argv)` (a port entry point), or of a JAX script's
    `main()` reading `sys.argv` when `argv0` is its name."""
    buf = io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [argv0, *argv])
    try:
        with redirect_stdout(buf):
            if argv0 == "script":
                assert main(argv) == 0
            else:
                main()
    finally:
        mp.undo()
    return buf.getvalue()


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


# ------------------------------------------------------------- the math
def _gaussians(n, d, seed, shift=0.3):
    r = np.random.default_rng(seed)
    mix = r.normal(size=(d, d)) / np.sqrt(d)
    a = r.normal(size=(n, d)) @ mix
    b = r.normal(size=(n, d)) @ (mix + 0.2 * r.normal(size=(d, d)) / np.sqrt(d)) + shift
    return [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]


@pytest.mark.parametrize("n,d,rtol", [(400, 32, 1e-6), (2000, 64, 1e-6), (40, 64, 1e-5)])
def test_frechet_distance_matches_scipy(n, d, rtol):
    from dynamicvectorquantization_tpu.eval.fid import frechet_distance as jfd

    (mu1, s1), (mu2, s2) = _gaussians(n, d, seed=n + d)
    ref = jfd(mu1, s1, mu2, s2)
    got = fid.frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, ref, rtol=rtol)
    assert abs(fid.frechet_distance(mu1, s1, mu1, s1)) < 1e-6 * np.trace(s1)


def test_frechet_distance_stays_finite_on_singular_covariances():
    (mu1, s1), (mu2, s2) = _gaussians(10, 64, seed=3)
    assert np.linalg.matrix_rank(s1) < 64
    got = fid.frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got) and isinstance(got, float) and got > 0
    # the analytic case: equal covariances, means apart by d -> |d|^2
    np.testing.assert_allclose(fid.frechet_distance(np.zeros(4), np.eye(4), np.array(
        [1.0, 2.0, 0.0, 0.0]), np.eye(4)), 5.0, atol=1e-9)


def test_statistics_and_proxy_features_equal_jax():
    from dynamicvectorquantization_tpu.eval.fid import compute_statistics as jstats

    jcf = _script("compute_fid")
    r = np.random.default_rng(0)
    batches = [r.uniform(-1, 1, size=(8, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    mine, theirs = compute_fid.proxy_feature_fn(), jcf.proxy_feature_fn()
    for b in batches:
        np.testing.assert_array_equal(mine(b), theirs(b))
    fn = compute_fid.proxy_feature_fn()
    mu, sigma = fid.compute_statistics(batches, fn)
    mu_r, sigma_r = jstats(batches, jcf.proxy_feature_fn())
    np.testing.assert_array_equal(mu, mu_r)
    np.testing.assert_array_equal(sigma, sigma_r)


# ------------------------------------------------------------- Inception
@pytest.fixture(scope="module")
def inception_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "inception_v3_seeded.pth"
    torch.save(seeded_state_dict(0), path)
    return str(path)


def test_inception_copy_equals_jax(inception_weights):
    from dynamicvectorquantization_tpu.eval.inception_torch import load_inception as jload

    ours, theirs = load_inception(inception_weights), jload(inception_weights)
    assert sorted(ours.state_dict()) == sorted(theirs.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 299, 299)).astype(np.float32))
    with torch.no_grad():
        a, b = ours(x), theirs(x)
    assert a.shape == (1, 2048) and float(a.abs().max()) > 0.1  # features that carry signal
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_inception_feature_fn_preprocesses_as_jax(inception_weights, monkeypatch):
    from dynamicvectorquantization_tpu.eval import fid as jfid

    monkeypatch.setenv("DQVQ_INCEPTION_WEIGHTS", inception_weights)
    images = np.random.default_rng(2).uniform(-1, 1, size=(2, 64, 48, 3)).astype(np.float32)
    ours = fid.inception_feature_fn(device="cpu")
    got = ours(images)
    np.testing.assert_allclose(got, jfid.inception_feature_fn()(images), atol=1e-5, rtol=0)
    assert np.abs(got[0] - got[1]).max() > 1e-4  # the two images' features differ
    count, rate = fid.images_per_s(ours)
    assert count == 2 and rate > 0 and "torchvision" in fid.INCEPTION_VARIANT
    monkeypatch.delenv("DQVQ_INCEPTION_WEIGHTS")
    with pytest.raises(FileNotFoundError):
        fid.inception_feature_fn(device="cpu")


def test_inception_loading_is_strict(tmp_path, inception_weights):
    sd = torch.load(inception_weights, weights_only=True)
    bad = tmp_path / "extra.pth"
    torch.save({**sd, "not_inception.weight": torch.zeros(3)}, bad)
    with pytest.raises(ValueError, match="unexpected"):
        load_inception(str(bad))
    torch.save({k: v for k, v in sd.items() if not k.startswith("Mixed_7c.")}, bad)
    with pytest.raises(ValueError, match="missing"):
        load_inception(str(bad))
    torch.save({"state_dict": {k: v for k, v in sd.items()
                               if not k.endswith("num_batches_tracked")}}, bad)
    assert isinstance(load_inception(str(bad)), InceptionV3)


# ------------------------------------------------------------ compute_fid
def _dumps(root, name, seed, n=160, size=128, shift=0):
    d = root / name
    d.mkdir()
    r = np.random.default_rng(seed)
    for i in range(2):
        arr = np.clip(r.normal(127 + shift, 60, size=(n, size, size, 3)), 0, 255).astype(np.uint8)
        with open(d / f"batch_{i:05d}.pkl", "wb") as f:
            pickle.dump(arr, f)
    return str(d)


def test_compute_fid_on_pkl_dumps_prints_jax_value(tmp_path):
    """320 images a side at 128^2: 768 pixels a feature row, 256 features, so
    the covariances have full rank."""
    from dynamicvectorquantization_tpu.eval.fid import fid_between as jfid_between

    jcf = _script("compute_fid")
    a, b = _dumps(tmp_path, "a", 1), _dumps(tmp_path, "b", 2, shift=20)
    argv = ["--a", a, "--b", b, "--proxy_features", "--batch_size", "64"]
    ours = _last_json(_run(compute_fid.main, argv + ["--device", "cpu"]))
    theirs = _last_json(_run(jcf.main, argv, argv0="compute_fid.py"))
    assert ours["metric"] == theirs["metric"] == "proxy_fid"
    assert ours["variant"] == compute_fid.PROXY_VARIANT and ours["images"] == [320, 320]
    ref = jfid_between(jcf.iter_source(a, 64), jcf.iter_source(b, 64), jcf.proxy_feature_fn())
    np.testing.assert_allclose(ours["value_unrounded"], ref, rtol=1e-5)
    np.testing.assert_allclose(ours["value"], theirs["value"], rtol=1e-5)
    assert ours["value"] > 1.0


def test_image_folder_reader_equals_the_jax_scripts(tmp_path, monkeypatch):
    """`iter_source` over an image folder (the JPEG / PNG fixtures, CMYK, a
    PNG named .JPEG, grey, and palette / RGBA PNGs written here): the JAX
    script's `Image.open(p).convert("RGB").resize(..., BICUBIC)` batches,
    bit for bit, also with PIL blocked on the port's side."""
    import shutil

    from PIL import Image

    fixtures = os.path.join(_REPO, "tests", "fixtures", "images")
    for name in os.listdir(fixtures):
        if not name.endswith((".py", ".json")):
            shutil.copy(os.path.join(fixtures, name), tmp_path / name.lower())
    r = np.random.default_rng(12)
    pal = Image.fromarray(r.integers(0, 30, size=(50, 70), dtype=np.uint8), "P")
    pal.putpalette(r.integers(0, 256, size=90, dtype=np.uint8).tobytes())
    pal.save(tmp_path / "sub_palette.png")
    Image.fromarray(r.integers(0, 256, size=(40, 60, 4), dtype=np.uint8)).save(
        tmp_path / "sub_rgba.png")
    theirs = list(_script("compute_fid").iter_source(str(tmp_path), 4, size=48))
    ours = list(compute_fid.iter_source(str(tmp_path), 4, size=48))
    assert [len(b) for b in ours] == [len(b) for b in theirs] == [4, 4, 4, 1]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for a, b in zip(compute_fid.iter_source(str(tmp_path), 4, size=48), theirs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the tiny DQ-VAE, shared weights
@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The JAX tiny dual-entropy model's perturbed init, exported as a
    reference-named `.ckpt` (the JAX package's exporter), and its variables."""
    import jax

    from dynamicvectorquantization_tpu.config.yaml_config import load_config as jload
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config as jinst
    from dynamicvectorquantization_tpu.utils.torch_ckpt import export_dqvae_state_dict
    from tests.test_torch_stackgpt import perturbed

    cfg = jload([DQVAE_TINY], [])["model"]
    cfg["params"]["lossconfig"] = None
    jm = jinst(cfg)
    jvars = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    r = np.random.default_rng(5)
    codebook = (0.5 * r.normal(size=(65, 32))).astype(np.float32)
    codebook[64] = 0.0
    jvars = {"params": perturbed(jvars["params"], r, 0.05),
             "ema": {"quantize": {**jvars["ema"]["quantize"], "codebook": codebook}}}
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in export_dqvae_state_dict(jvars).items()}
    sd["loss.discriminator.main.0.weight"] = torch.zeros(1)  # a key that is not the model's
    path = tmp_path_factory.mktemp("tiny") / "tiny_dqvae.ckpt"
    torch.save({"state_dict": sd}, path)
    return str(path), jm, jvars


@pytest.fixture(scope="module")
def val_npys(tmp_path_factory):
    d = tmp_path_factory.mktemp("val")
    r = np.random.default_rng(9)
    for i in range(2):
        x = r.uniform(-1, 1, size=(4, 64, 64, 3)).astype(np.float32)
        x[:, :, :32] = 0.1  # a smooth half, so both grains occur
        np.save(d / f"val_{i}.npy", x)
    return str(d)


def test_rfid_reconstructions_and_codes_match_jax(tiny_ckpt, val_npys):
    import jax

    from dynamicvectorquantization_tpu.eval import fid as jfid
    from dynamicvectorquantization_torch.utils.model_loading import load_first_stage_model

    path, jm, jvars = tiny_ckpt
    model = load_first_stage_model(DQVAE_TINY, path, device="cpu")
    batches = list(compute_fid.iter_source(val_npys, 4))
    fwd = jax.jit(lambda v, x: jm.net.apply(v, x)[0])
    enc = jax.jit(lambda v, x: jm.encode(v, x)[2][2])
    for b in batches:
        x, rec = fid.reconstruct(model, b)
        np.testing.assert_allclose(rec, np.asarray(fwd(jvars, b)), atol=1e-4, rtol=0)
        with torch.no_grad():
            codes = model.encode(torch.from_numpy(b))[2][2].numpy()
        np.testing.assert_array_equal(codes, np.asarray(enc(jvars, b)))
    value = fid.rfid(model, batches, compute_fid.proxy_feature_fn())
    ref = jfid.rfid(jm, jvars, batches, compute_fid.proxy_feature_fn())
    # 8 images, 192 pixels a row: singular covariances, and reconstructions 1e-4 apart
    np.testing.assert_allclose(value, ref, rtol=1e-3)
    out = _last_json(_run(compute_fid.main, ["--rfid", "--yaml_path", DQVAE_TINY, "--model_path",
                                             path, "--b", val_npys, "--proxy_features",
                                             "--batch_size", "4", "--device", "cpu"]))
    assert out["metric"] == "proxy_rfid" and out["images"] == 8
    np.testing.assert_allclose(out["value_unrounded"], value, rtol=1e-12)


def test_codebook_usage_prints_jax_numbers(tiny_ckpt):
    path, _, _ = tiny_ckpt
    argv = ["--yaml_path", DQVAE_TINY, "--model_path", path, "--batch_size", "4",
            "--max_batches", "3"]
    ours = _run(codebook_usage.main, argv + ["--device", "cpu"]).strip().splitlines()
    theirs = _run(_script("codebook_usage_dqvae").main, argv,
                  argv0="codebook_usage_dqvae.py").strip().splitlines()
    assert ours[:2] == [line.strip() for line in theirs[-2:]]
    res = json.loads(ours[-1])
    assert res["images"] == 12 and 0 < res["codes_used"] <= res["codebook_size"] == 64


def test_codebook_pca_prints_jax_variance(tiny_ckpt, tmp_path):
    path, _, _ = tiny_ckpt
    argv = ["--yaml_path", DQVAE_TINY, "--model_path", path]
    ours = _run(codebook_pca.main, argv + ["--device", "cpu", "--out", str(tmp_path / "a.png")])
    theirs = _run(_script("codebook_pca").main, argv + ["--out", str(tmp_path / "b.png")],
                  argv0="codebook_pca.py")
    value = float(ours.splitlines()[0].rsplit(" ", 1)[1])
    np.testing.assert_allclose(value, float(theirs.strip().rsplit(" ", 1)[1]), rtol=1e-6)
    from PIL import Image

    a, b = (np.asarray(Image.open(tmp_path / n)) for n in ("a.png", "b.png"))
    np.testing.assert_array_equal(a, b)  # the same scatter, rasterised alike


# ------------------------------------------------------------ parity_report
def test_parity_report_legs_match_jax(tiny_ckpt, val_npys, tmp_path):
    path, _, _ = tiny_ckpt
    missing = str(tmp_path / "no_reference_repo")
    argv = ["--yaml_path", DQVAE_TINY, "--ref_ckpt", path, "--images", val_npys,
            "--proxy_features", "--size", "64", "--batch_size", "4", "--limit", "8",
            "--reference_repo", missing]
    ours = _last_json(_run(parity_report.main, argv + ["--device", "cpu", "--out",
                                                      str(tmp_path / "ours.json")]))
    _run(_script("parity_report").main, argv + ["--out", str(tmp_path / "jax.json")],
         argv0="parity_report.py")
    with open(tmp_path / "ours.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    assert ours["verdict"] == ref["verdict"] == "INCOMPLETE"
    for leg in parity_report.LEGS:
        assert mine[leg]["status"] == ref[leg]["status"], leg
        assert mine[leg].get("reason") == ref[leg].get("reason"), leg
    assert mine["legs_ran"] == ref["legs_ran"] == ["ckpt_import", "rfid"]
    assert mine["ckpt_import"]["parameters"] == ref["ckpt_import"]["parameters"]
    assert mine["rfid"]["metric"] == ref["rfid"]["metric"] == "proxy_rfid"
    np.testing.assert_allclose(mine["rfid"]["value_unrounded"], ref["rfid"]["value"],
                               rtol=1e-3, atol=1e-4)
    assert mine["variant"] == ours["variant"] == mine["rfid"]["variant"]


def test_parity_report_import_leg_refuses_missing_keys(tiny_ckpt, tmp_path):
    path, _, _ = tiny_ckpt
    sd = torch.load(path, weights_only=False)["state_dict"]
    bad = tmp_path / "bad.ckpt"
    torch.save({"state_dict": {k: v for k, v in sd.items() if not k.startswith("decoder.")}},
               bad)
    with pytest.raises(RuntimeError, match="Missing key"):
        _run(parity_report.main, ["--yaml_path", DQVAE_TINY, "--ref_ckpt", str(bad),
                                  "--device", "cpu", "--out", str(tmp_path / "r.json")])


def test_parity_report_samples_through_sample_val(tmp_path):
    """The sample_fid leg: a `sample.val` process at the tiny stage-2 config
    (seeded weights saved as the stage-2 checkpoint), then FID of its dump
    against the images."""
    from dynamicvectorquantization_torch.utils.model_loading import load_model_and_variables

    model, sd = load_model_and_variables(STAGE2_TINY, seed=3, device="cpu")
    ckpt = tmp_path / "stage2.pt"
    torch.save(sd, ckpt)
    size = model.first_stage_model.image_size
    images = tmp_path / "images"
    images.mkdir()
    np.save(images / "x.npy",
            np.random.default_rng(4).uniform(-1, 1, size=(8, size, size, 3)).astype(np.float32))
    out = _last_json(_run(parity_report.main, [
        "--yaml_path", DQVAE_TINY, "--images", str(images), "--stage2_yaml", STAGE2_TINY,
        "--stage2_ckpt", str(ckpt), "--sample_num", "4", "--batch_size", "4", "--size",
        str(size), "--proxy_features", "--sample_dir", str(tmp_path / "samples"),
        "--device", "cpu", "--out", str(tmp_path / "r.json")]))
    assert out["ran"] == ["rfid", "sample_fid"] and out["verdict"] == "INCOMPLETE"
    with open(tmp_path / "r.json") as f:
        leg = json.load(f)["sample_fid"]
    assert leg["metric"] == "proxy_fid" and np.isfinite(leg["value"]) and leg["samples"] == 4
    assert os.listdir(tmp_path / "samples" / "numpys") == ["batch_00000.pkl"]
