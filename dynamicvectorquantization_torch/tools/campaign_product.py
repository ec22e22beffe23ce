"""A two-stage convergence campaign through the port's own entry points
(counterpart of the JAX package's `scripts/tools/campaign_product.py`: the
same flags, legs, outputs and summary keys):

  1. JPEG-encode a synthetic pool (`data/synthetic.py` `build_pool`) as an
     ImageNet-layout tree `<data_root>/{train,val}/cls_<c>/img_<i>.jpg`
     (PIL writes it; `--skip_data` reuses a tree);
  2. the entropy-threshold table over the train tree
     (`tools.calculate_entropy_thresholds`);
  3. stage 1 through `train.cli` (the stage-1 entropy yml, f32, batch 8);
  4. stage 2 through `train.cli` (the p6c18 yml at its bf16 cached-codes
     defaults, stream caps 160 / 644, one image grid an epoch);
  5. `sample.val` from every retained stage-2 checkpoint (float caches) and
     `eval.compute_fid --proxy_features` of the samples against the val tree;
  6. `<out>/summary.json` (merged into an existing one), `curves.png` where
     matplotlib imports, and copies of each stage's `metrics.jsonl` and
     `argv.json` beside it.

    python -m dynamicvectorquantization_torch.tools.campaign_product \\
        --out artifacts/campaign_torch_r01 --skip_data --data_root <tree>

Each leg is a process of its own. A training leg that fails is run again
with `--resume` into the run directory it started, so a campaign cut short
picks up where it stopped; `--skip_s1` / `--skip_s2` skip finished legs, and
samples already on disk are reused. `--device` goes to every leg (default:
the CUDA card; `cpu` runs the plain versions).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGE1_BASE = ("configs/stage1/dqvae-entropy-dual-r05_imagenet.yml",)
STAGE2_BASE = ("configs/stage2/uncond_imagenet_p6c18.yml",)
STAGE2_MAX_LENS = (160, 644)  # coarse / fine stream caps; None: the yml's own
THRESHOLDS_NAME = "entropy_thresholds_imagenet_train_patch-16.json"
SUMMARY_KEYS = ("args", "t_start", "s1_seconds", "s1_rate", "s1_val", "s2_seconds",
                "s2_rate", "s2_cache_encode_seconds", "s2_val", "s2_checkpoints_kept",
                "s2_best_val_step", "s2_best_val_retained", "s2_sample_proxy_fid",
                "t_total_seconds")


def log(msg):
    print(f"[campaign {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_jpeg_tree(root, n_train, n_val, n_classes, size, seed, quality=95):
    from PIL import Image

    from ..data.synthetic import build_pool

    t0 = time.time()
    for split, n, sd in (("train", n_train, seed), ("val", n_val, seed + 999)):
        pool = build_pool(n, size, seed=sd)
        for i in range(n):
            d = os.path.join(root, split, f"cls_{i % n_classes:03d}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(pool[i]).save(os.path.join(d, f"img_{i:05d}.jpg"), quality=quality)
    log(f"JPEG tree: {n_train}+{n_val} images in {time.time() - t0:.0f}s -> {root}")


def resume_argv(cmd, rundir):
    """`cmd` without `--name` / `--logdir` (a resume takes the run's own),
    with `--resume rundir`."""
    dropped = ("--name", "--logdir")
    base = [a for i, a in enumerate(cmd)
            if not (a in dropped or (i > 0 and cmd[i - 1] in dropped))]
    return base + ["--resume", rundir]


def run(cmd, env_extra=None, tag="", resume_glob=None, retries=2):
    """Run a leg; a training leg that fails is run again with `--resume`
    into the newest run directory under `resume_glob` (its checkpoints make
    the leg idempotent). Returns the leg's seconds."""
    env = {**os.environ, **(env_extra or {})}
    t0 = time.time()
    attempt_cmd = list(cmd)
    for attempt in range(retries + 1):
        log(f"run[{tag}]{f' (retry {attempt})' if attempt else ''}: " + " ".join(attempt_cmd))
        p = subprocess.run(attempt_cmd, env=env, cwd=REPO)
        if p.returncode == 0:
            dt = time.time() - t0
            log(f"done[{tag}] in {dt:.0f}s")
            return dt
        if attempt == retries or not resume_glob:
            raise SystemExit(f"{tag} failed with {p.returncode}")
        dirs = sorted(glob.glob(resume_glob))
        if not dirs:
            log(f"{tag} failed ({p.returncode}); no run dir yet: rerunning")
            continue
        log(f"{tag} failed ({p.returncode}); resuming {dirs[-1]}")
        attempt_cmd = resume_argv(cmd, dirs[-1])


def read_metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def rate_stats(rows):
    """First, median, p10, p90 and last of the train rows' images/s."""
    rates = [r["images_per_sec"] for r in rows
             if r["split"] == "train" and "images_per_sec" in r]
    if not rates:
        return {}
    a = np.asarray(rates)
    return {"n": len(a), "first": round(float(a[0]), 2),
            "median": round(float(np.median(a)), 2),
            "p10": round(float(np.percentile(a, 10)), 2),
            "p90": round(float(np.percentile(a, 90)), 2), "last": round(float(a[-1]), 2)}


def stage1_summary(rows):
    return {"s1_rate": rate_stats(rows),
            "s1_val": [{"step": r["step"], "val_rec_loss": r.get("val_rec_loss")}
                       for r in rows if r["split"] == "val"],
            "s1_val_fine_ratio": [{"step": r["step"], "val_fine_ratio": r.get("val_fine_ratio")}
                                  for r in rows if r["split"] == "val"]}


def stage2_summary(rows, kept):
    """The stage-2 keys; `kept` are the retained checkpoints' steps."""
    vals = [(r["step"], r["val_loss"]) for r in rows if r["split"] == "val"]
    best = min(vals, key=lambda sv: sv[1])[0] if vals else None
    return {"s2_rate": rate_stats(rows),
            "s2_cache_encode_seconds": [r["cache_encode_seconds"] for r in rows
                                        if "cache_encode_seconds" in r],
            "s2_val": [{"step": s, "val_loss": v} for s, v in vals],
            "s2_checkpoints_kept": list(kept), "s2_best_val_step": best,
            "s2_best_val_retained": best in kept}


def last_json(text, metric):
    """The value of the last stdout JSON line of `compute_fid` for `metric`."""
    for ln in reversed(text.strip().splitlines()):
        try:
            obj = json.loads(ln)
        except json.JSONDecodeError:
            continue
        return obj.get("value") if obj.get("metric") == metric else obj.get(metric)
    return None


def _module(name):
    return [sys.executable, "-m", f"dynamicvectorquantization_torch.{name}"]


def main(argv=None):
    p = argparse.ArgumentParser(description="two-stage campaign through the port's entry points")
    p.add_argument("--out", default="artifacts/campaign_torch_r01")
    p.add_argument("--train_images", type=int, default=3072)
    p.add_argument("--val_images", type=int, default=256)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--s1_epochs", type=int, default=6)
    p.add_argument("--s2_epochs", type=int, default=6)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--sample_num", type=int, default=96)
    p.add_argument("--skip_data", action="store_true", help="reuse an existing data tree")
    p.add_argument("--skip_s1", action="store_true")
    p.add_argument("--skip_s2", action="store_true")
    p.add_argument("--data_root", default=None, help="the JPEG tree (default: <out>/data)")
    p.add_argument("--device", default=None,
                   help="device of every leg; default the CUDA card, `cpu` for the plain versions")
    opt = p.parse_args(argv)

    from ..train.stage1 import resolve_remat
    from ..utils.device import resolve_device

    device = resolve_device(opt.device)  # no card and no --device: stop before any leg
    dev = ["--device", str(device)]
    out = os.path.abspath(opt.out)
    data_root = os.path.abspath(opt.data_root or os.path.join(out, "data"))
    logroot = os.path.join(out, "logs")
    os.makedirs(out, exist_ok=True)
    env = {"DQVQ_IMAGENET_ROOT": data_root}
    summary = {}
    spath = os.path.join(out, "summary.json")
    if os.path.exists(spath):  # a skip-flag re-run keeps the recorded leg timings
        with open(spath) as f:
            summary = json.load(f)
    summary.update({"args": vars(opt), "t_start": time.time(), "device": str(device)})
    legs = summary.setdefault("leg_seconds", {})

    if not opt.skip_data:
        build_jpeg_tree(data_root, opt.train_images, opt.val_images, opt.classes,
                        opt.image_size, opt.seed)

    thr_dir = os.path.join(out, "thresholds")
    thr_json = os.path.join(thr_dir, THRESHOLDS_NAME)
    if os.path.exists(thr_json):
        log(f"thresholds: reusing {thr_json}")
    else:
        legs["thresholds"] = run(
            _module("tools.calculate_entropy_thresholds") + [
                "--dataset", "imagenet", "--split", "train", "--image_size",
                str(opt.image_size), "--out_dir", thr_dir] + dev, env, "thresholds")
    assert os.path.exists(thr_json)

    common_data = [f"data.params.batch_size={opt.batch_size}", "data.params.num_workers=2"]
    router_json = f"router_config.params.json_path={thr_json}"
    if not opt.skip_s1:
        summary["s1_seconds"] = legs["stage1"] = run(
            _module("train") + ["--base", *STAGE1_BASE] + [
                "--max_epochs", str(opt.s1_epochs), "--name", "s1", "--logdir", logroot,
                "--log_every", "8", "--steps_per_dispatch", "4", "--seed", str(opt.seed),
                *dev, f"model.params.encoderconfig.params.{router_json}"] + common_data,
            env, "stage1", resume_glob=os.path.join(logroot, "s1-*"))
        summary["s1_remat"] = resolve_remat(None, device)  # the CLI's default
    s1_dir = sorted(glob.glob(os.path.join(logroot, "s1-*")))[-1]
    s1_rows = read_metrics(s1_dir)
    summary.update(stage1_summary(s1_rows))

    if not opt.skip_s2:
        caps = [] if STAGE2_MAX_LENS is None else [
            f"model.params.permuter_config.params.coarse_max_len={STAGE2_MAX_LENS[0]}",
            f"model.params.permuter_config.params.fine_max_len={STAGE2_MAX_LENS[1]}"]
        summary["s2_seconds"] = legs["stage2"] = run(
            _module("train") + ["--base", *STAGE2_BASE] + [
                "--max_epochs", str(opt.s2_epochs), "--name", "s2", "--logdir", logroot,
                "--log_every", "8", "--seed", str(opt.seed), "--image_log_every", "384", *dev,
                "model.params.first_stage_config.params."
                f"ckpt_path={os.path.join(s1_dir, 'checkpoints')}",
                f"model.params.first_stage_config.params.encoderconfig.params.{router_json}",
                *caps] + common_data,
            env, "stage2", resume_glob=os.path.join(logroot, "s2-*"))
    s2_dir = sorted(glob.glob(os.path.join(logroot, "s2-*")))[-1]
    s2_rows = read_metrics(s2_dir)
    from ..utils.checkpoint import CheckpointManager

    ckpts = CheckpointManager(os.path.join(s2_dir, "checkpoints"))
    summary.update(stage2_summary(s2_rows, ckpts.all_steps()))

    merged_yaml = os.path.join(s2_dir, "configs", "merged-project.yaml")
    fid_curve = []
    for step in summary["s2_checkpoints_kept"]:
        sdir = os.path.join(out, "samples", f"step_{step}")
        if glob.glob(os.path.join(sdir, "numpys", "*")):
            log(f"sample@{step}: reusing existing {sdir}")
        else:
            legs[f"sample@{step}"] = run(
                _module("sample.val") + [
                    "--yaml_path", merged_yaml, "--model_path", ckpts.path(step),
                    "--save_path", sdir, "--batch_size", "32", "--sample_num",
                    str(opt.sample_num), "--top_k", "300", "--top_k_pos", "1024",
                    "--save_grids"] + dev, env, f"sample@{step}")
        t0 = time.time()
        r = subprocess.run(
            _module("eval.compute_fid") + [
                "--a", os.path.join(sdir, "numpys"), "--b", os.path.join(data_root, "val"),
                "--proxy_features", "--size", str(opt.image_size)] + dev,
            env={**os.environ, **env}, cwd=REPO, capture_output=True, text=True)
        legs[f"fid@{step}"] = time.time() - t0
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
            raise SystemExit(f"fid@{step} failed with {r.returncode}")
        fid = last_json(r.stdout, "proxy_fid")
        log(f"proxy_fid@{step}: {fid}")
        fid_curve.append({"step": step, "proxy_fid": fid})
    summary["s2_sample_proxy_fid"] = fid_curve

    summary["t_total_seconds"] = round(time.time() - summary["t_start"], 0)
    summary["curves"] = plot_curves(out, s1_rows, s2_rows, fid_curve)
    with open(spath, "w") as f:
        json.dump(summary, f, indent=1)
    # small committable copies of the run logs (the log dirs hold GB checkpoints)
    for tag, d in (("stage1", s1_dir), ("stage2", s2_dir)):
        for n in ("metrics.jsonl", "argv.json"):
            if os.path.exists(os.path.join(d, n)):
                shutil.copyfile(os.path.join(d, n), os.path.join(out, f"{tag}_{n}"))
    log("summary written: " + spath)
    print(json.dumps(summary, indent=1))
    return 0


def plot_curves(out, s1_rows, s2_rows, fid_curve):
    """`<out>/curves.png` (the JAX script's six panels); returns its name, or
    why it was not drawn."""
    try:
        import matplotlib
    except ImportError:
        return "not drawn: matplotlib absent"
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def series(rows, split, key):
        sel = [(r["step"], r[key]) for r in rows if r["split"] == split and r.get(key) is not None]
        return [s for s, _ in sel], [v for _, v in sel]

    panels = [
        ("stage-1 reconstruction", s1_rows, [("train", "train_rec_loss"), ("val", "val_rec_loss")]),
        ("stage-1 rate (loader)", s1_rows, [("train", "images_per_sec")]),
        ("dual-grain routing", s1_rows, [("train", "train_fine_ratio")]),
        ("stage-2 loss", s2_rows, [("train", "train_loss"), ("val", "val_loss")]),
        ("stage-2 rate (cached codes)", s2_rows, [("train", "images_per_sec")]),
    ]
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for ax, (title, rows, keys) in zip(axes.ravel(), panels):
        for split, key in keys:
            style = "--o" if split == "val" else "-"
            ax.plot(*series(rows, split, key), style, ms=3, label=key)
        ax.set_xlabel("step"); ax.set_title(title); ax.legend(fontsize=8)  # noqa: E702
    fid = [r for r in fid_curve if r.get("proxy_fid") is not None]
    if fid:
        ax = axes[1, 2]
        ax.plot([r["step"] for r in fid], [r["proxy_fid"] for r in fid], "-o", ms=4,
                label="proxy_fid(samples, val)")
        ax.set_xlabel("checkpoint step"); ax.set_title("sample quality proxy")  # noqa: E702
        ax.legend(fontsize=8)
    fig.suptitle("Two-stage campaign through the PyTorch port's entry points")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "curves.png"), dpi=110)
    plt.close(fig)
    return "curves.png"


if __name__ == "__main__":
    sys.exit(main())
