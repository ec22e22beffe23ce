"""The port's two campaign tools (`tools/campaign_product.py`,
`tools/convergence_campaign.py`).

Deterministic pieces against committed files: the summary functions over
the JAX campaigns' metrics give those runs' `summary.json` fields; the
finalize curves over `artifacts/campaign_r03/` give `BENCH_train_r03.json`'s;
the synthetic threshold and the thresholds tool equal the JAX ones (both on
the CPU). Plumbing: each tool runs end to end with `--device cpu` at the
tiny configs over a few committed JPEGs / a small synthetic pool.
"""
import json
import os

import numpy as np
import pytest
import torch

from dynamicvectorquantization_torch.config.yaml_config import dump_yaml, load_config
from dynamicvectorquantization_torch.tools import campaign_product as cp
from dynamicvectorquantization_torch.tools import convergence_campaign as cc

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(_REPO, "artifacts")
DATA = os.path.join(ART, "campaign_r05", "data")
TINY1 = os.path.join(_REPO, "configs/smoke/dqvae-dual-entropy-tiny.yml")
TINY2 = os.path.join(_REPO, "configs/smoke/dqtransformer-uncond-tiny.yml")
JAX_KEYS = ("s1_rate", "s1_val", "s2_rate", "s2_val", "s2_cache_encode_seconds",
            "s2_best_val_step")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.parametrize("run", ["campaign_r04", "campaign_r05"])
def test_summary_functions_reproduce_the_jax_summaries(run):
    d = os.path.join(ART, run)
    with open(os.path.join(d, "summary.json")) as f:
        ref = json.load(f)
    got = {**cp.stage1_summary(_rows(os.path.join(d, "stage1_metrics.jsonl"))),
           **cp.stage2_summary(_rows(os.path.join(d, "stage2_metrics.jsonl")),
                               ref["s2_checkpoints_kept"])}
    for k in JAX_KEYS:
        assert got[k] == ref[k], k
    assert got["s2_best_val_retained"] == ref["s2_best_val_retained"]
    assert {r["val_fine_ratio"] for r in got["s1_val_fine_ratio"]} == {0.504608154296875}


def test_finalize_curves_reproduce_bench_train_r03(tmp_path):
    with open(os.path.join(_REPO, "BENCH_train_r03.json")) as f:
        ref = json.load(f)["curves"]
    src = os.path.join(ART, "campaign_r03")
    for n in ("stage1_metrics.jsonl", "stage2_metrics.jsonl"):
        os.symlink(os.path.join(src, n), tmp_path / n)
    bench = cc.finalize(str(tmp_path), plot=False)
    assert bench["curves"] == ref
    assert not any(n.startswith("BENCH") for n in os.listdir(tmp_path))


def test_synthetic_threshold_equals_jax():
    import jax
    import jax.numpy as jnp

    from dynamicvectorquantization_tpu.data.synthetic import build_pool, decode_pool_batch
    from dynamicvectorquantization_tpu.ops.entropy import patch_entropy

    pool = build_pool(80, 64, seed=3)
    ents = []
    for i in range(0, 80, 64):  # the JAX tool's `_synthetic_threshold` loop
        x = decode_pool_batch(pool, np.arange(i, min(i + 64, 80)))
        ents.append(np.asarray(jax.jit(patch_entropy)(jnp.asarray(x))).ravel())
    ref = float(np.median(np.concatenate(ents)))
    got = cc.synthetic_threshold(pool, device=torch.device("cpu"))
    assert abs(got - ref) <= 1e-6 + 1e-5 * abs(ref)


def _subtree(root, n_train, n_val):
    """`n_train` + `n_val` committed JPEGs linked into an ImageNet-layout tree."""
    for split, n in (("train", n_train), ("val", n_val)):
        classes = sorted(os.listdir(os.path.join(DATA, split)))
        for i in range(n):
            cls = classes[i % len(classes)]
            name = sorted(os.listdir(os.path.join(DATA, split, cls)))[i // len(classes)]
            os.makedirs(os.path.join(root, split, cls), exist_ok=True)
            os.symlink(os.path.join(DATA, split, cls, name), os.path.join(root, split, cls, name))
    return str(root)


def test_thresholds_tool_equals_jax_on_committed_files(tmp_path, monkeypatch):
    import sys

    from dynamicvectorquantization_torch.tools import calculate_entropy_thresholds as port_tool

    root = _subtree(tmp_path / "data", 64, 0)
    monkeypatch.setenv("DQVQ_IMAGENET_ROOT", root)
    port_tool.main(["--dataset", "imagenet", "--split", "train", "--out_dir",
                    str(tmp_path / "port"), "--device", "cpu"])
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_calculate_entropy_thresholds",
        os.path.join(_REPO, "scripts", "tools", "calculate_entropy_thresholds.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["x", "--dataset", "imagenet", "--split", "train",
                                      "--out_dir", str(tmp_path / "jax")])
    jax_tool.main()
    name = cp.THRESHOLDS_NAME
    with open(tmp_path / "port" / name) as f:
        got = json.load(f)
    with open(tmp_path / "jax" / name) as f:
        ref = json.load(f)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6 + 1e-4 * abs(ref[k]), k


def _tiny_yml(path, src, size):
    cfg = load_config([src])
    split = lambda cls, ev: {"target": f"data.imagenet.{cls}",  # noqa: E731
                             "params": {"config": {"is_eval": ev, "size": size}}}
    cfg["data"]["params"]["train"] = split("ImageNetTrain", False)
    cfg["data"]["params"]["validation"] = split("ImageNetValidation", True)
    with open(path, "w") as f:
        f.write(dump_yaml(cfg) + "\n")
    return str(path)


def test_campaign_product_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(cp, "STAGE1_BASE", (_tiny_yml(tmp_path / "s1.yml", TINY1, 64),))
    monkeypatch.setattr(cp, "STAGE2_BASE", (_tiny_yml(tmp_path / "s2.yml", TINY2, 64),))
    monkeypatch.setattr(cp, "STAGE2_MAX_LENS", None)
    root = _subtree(tmp_path / "data", 64, 16)  # the thresholds tool takes whole batches of 64
    out = tmp_path / "out"
    assert cp.main(["--out", str(out), "--skip_data", "--data_root", root, "--image_size", "64",
                    "--s1_epochs", "1", "--s2_epochs", "1", "--sample_num", "4",
                    "--device", "cpu"]) == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert set(cp.SUMMARY_KEYS) <= set(summary)
    assert summary["s2_best_val_retained"] and summary["s2_checkpoints_kept"] == [8]
    assert [r["step"] for r in summary["s1_val"]] == [8]
    assert np.isfinite(summary["s2_sample_proxy_fid"][0]["proxy_fid"])
    assert summary["s1_remat"] is False and summary["device"] == "cpu"
    for n in ("stage1_metrics.jsonl", "stage2_metrics.jsonl", "stage1_argv.json",
              "stage2_argv.json"):
        assert (out / n).exists(), n


def test_campaign_product_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp.main(["--out", str(tmp_path), "--skip_data"])
    assert not os.listdir(tmp_path)


def test_convergence_campaign_runs_on_the_cpu(tmp_path):
    # ch 16 / z 32 / 64 codes: the first stage of the tiny stage-2 yml
    common = ["--out", str(tmp_path), "--device", "cpu", "--ch", "16", "--z-ch", "32",
              "--codebook", "64", "--image-size", "64", "--pool", "16", "--val", "8",
              "--batch", "2", "--dispatch", "2", "--log-every", "2", "--eval-every", "4",
              "--grid-every", "4", "--warmup", "1"]
    cc.main(["stage1", "--steps", "4", *common])
    s1 = _rows(tmp_path / "stage1_metrics.jsonl")
    assert [r["step"] for r in s1 if r["split"] == "val"] == [4, 4]
    assert all(np.isfinite(r["proxy_rfid"]) for r in s1 if r["split"] == "val")
    assert (tmp_path / "stage1_state.pt").exists()
    assert (tmp_path / "stage1_grid_000004.png").exists()
    cc.main(["stage2", "--steps", "4", "--config", os.path.relpath(TINY2, _REPO),
             "--max-lens", "none", "--sample-every", "4", "--top-k", "30", "--top-k-pos", "16",
             "--cached-codes", *common])
    s2 = _rows(tmp_path / "stage2_metrics.jsonl")
    assert [r["step"] for r in s2 if r["split"] == "train"] == [2, 4]
    assert all(np.isfinite(r["val_loss"]) for r in s2 if r["split"] == "val")
    assert (tmp_path / "stage2_samples_000004.png").read_bytes()[:4] == b"\x89PNG"
    cc.main(["finalize", "--out", str(tmp_path)])
    with open(tmp_path / "curves.json") as f:
        curves = json.load(f)["curves"]
    assert curves["stage1_val_rec_loss"] is not None and curves["stage2_val_loss"] is not None
