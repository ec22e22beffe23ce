"""One-command quality-parity protocol of a stage-1 model against the
reference (counterpart of the JAX package's `scripts/tools/parity_report.py`):

    DQVQ_INCEPTION_WEIGHTS=<torchvision inception_v3 .pth> \\
    python -m dynamicvectorquantization_torch.eval.parity_report \\
        --yaml_path configs/stage1/dqvae-entropy-dual-r05_imagenet.yml \\
        --ref_ckpt <reference stage-1 .ckpt> --images <val image tree> \\
        [--stage2_yaml <yml> --stage2_ckpt <ckpt> --sample_num 5000] --out parity_report.json

Legs, each recorded with status `ran` or `skipped` and the reason:
  1. ckpt_import      the reference `.ckpt` into the port's DQ-VAE by
                      `load_state_dict`: fails on a missing or unexpected
                      model key (the file's `loss.*` keys are not the model's);
  2. recon_tolerance  the reference torch model (its repository at
                      `--reference_repo` or `DQVQ_REFERENCE_REPO`, imported
                      only inside this leg) and the port on the same
                      batches: max |diff| of the reconstructions against
                      `--tolerance`;
  3. rfid             FID(images, the port's reconstructions of them) over
                      InceptionV3 pool3 (`eval/fid.py`), within
                      `--rfid_rel_tol` (1 %) of `--rfid_reference` (1.6968)
                      when a reference checkpoint was loaded;
  4. sample_fid       with `--stage2_yaml` and `--stage2_ckpt`: a
                      `python -m dynamicvectorquantization_torch.sample.val`
                      process samples `--sample_num` images, then
                      FID(samples, images).
Missing inputs mark their leg skipped. `--proxy_features` replaces
InceptionV3 by `compute_fid`'s seeded projection (plumbing only). The report
(`--out`) carries `variant`, the extractor the FID legs used: InceptionV3
here is torchvision's forward, not pytorch-fid's, so the 1 % verdict holds
against numbers of the same extractor only. The last stdout line is one JSON
object: the verdict (PASS, FAIL, INCOMPLETE), the legs that ran and were
skipped, the variant, the report's path. Runs on the CUDA card unless
`--device` names another device (passed on to the sampling process).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LEGS = ("ckpt_import", "recon_tolerance", "rfid", "sample_fid")


def log(msg):
    print(f"[parity {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _images(opt, path, limit):
    from .compute_fid import iter_source

    return iter_source(path, batch_size=opt.batch_size, limit=limit, size=opt.size)


def _feature_fn(opt, key, report):
    """(feature_fn, is_proxy); records the extractor under `key` and its
    variant. Raises FileNotFoundError without InceptionV3 weights."""
    from .compute_fid import feature_extractor

    fn, metric, report["variant"] = feature_extractor(opt.proxy_features, opt.device)
    is_proxy = metric == "proxy_fid"
    report[key] = ("proxy (plumbing-grade; NOT comparable to FID)" if is_proxy else
                   f"inception_v3 pool3 ({os.environ.get('DQVQ_INCEPTION_WEIGHTS')})")
    return fn, is_proxy


def _feature_rate(feature_fn):
    """The InceptionV3 forward's images and images/s (none for the proxy)."""
    if not hasattr(feature_fn, "calls"):
        return {}
    from .fid import images_per_s

    images, rate = images_per_s(feature_fn)
    return {"feature_images": images, "feature_images_per_s": rate}


def leg_ckpt_import(opt, report):
    """The model: the reference `.ckpt` loaded strictly by name, or seeded."""
    from ..utils.model_loading import load_first_stage_model, load_torch_state_dict

    model = load_first_stage_model(opt.yaml_path, None, opt.device)
    if not opt.ref_ckpt:
        report["ckpt_import"] = {"status": "skipped", "reason": "--ref_ckpt not given"}
        return model
    sd = {k: v for k, v in load_torch_state_dict(opt.ref_ckpt).items()
          if not k.startswith("loss.")}
    model.load_state_dict(sd, strict=True)  # raises on a missing or unexpected key
    report["ckpt_import"] = {"status": "ran", "ckpt": opt.ref_ckpt, "mapped_leaves": len(sd),
                             "parameters": int(sum(v.numel() for v in sd.values()))}
    log(f"ckpt_import: {len(sd)} tensors / {report['ckpt_import']['parameters']} values "
        f"from {opt.ref_ckpt}")
    return model


def _reference_model(opt):
    """The reference repository's model class for the config's target, built
    without its loss and loaded from `--ref_ckpt`."""
    from ..config.yaml_config import load_config

    if opt.reference_repo not in sys.path:
        sys.path.insert(0, opt.reference_repo)
    config = load_config([opt.yaml_path])["model"]
    mod_name, cls_name = config["target"].rsplit(".", 1)
    ref_cls = getattr(importlib.import_module(mod_name), cls_name)
    params = {k: v for k, v in config["params"].items() if k not in ("ckpt_path", "compute_dtype")}
    vq = dict(params["vqconfig"])
    vq["params"] = {k: v for k, v in (vq.get("params") or {}).items() if k != "use_pallas"}
    params["vqconfig"] = vq
    params["lossconfig"] = {"target": "modules.losses.vqperceptual.DummyLoss"}
    ref_model = ref_cls(**params)
    sd = torch.load(opt.ref_ckpt, map_location="cpu", weights_only=False)
    ref_model.load_state_dict(sd.get("state_dict", sd), strict=False)
    return ref_model.eval()


def leg_recon_tolerance(opt, report, model):
    if not (opt.ref_ckpt and opt.images):
        report["recon_tolerance"] = {"status": "skipped",
                                     "reason": "needs --ref_ckpt and --images"}
        return
    if not opt.reference_repo:
        report["recon_tolerance"] = {"status": "skipped", "reason": (
            "no reference repo given (--reference_repo or DQVQ_REFERENCE_REPO)")}
        return
    if not os.path.isdir(opt.reference_repo):
        report["recon_tolerance"] = {
            "status": "skipped", "reason": f"reference repo not found at {opt.reference_repo}"}
        return
    from .fid import reconstruct

    ref_model = _reference_model(opt)
    max_diff, mse, n = 0.0, 0.0, 0
    for b in _images(opt, opt.images, opt.recon_images):
        _, ours = reconstruct(model, b)
        with torch.no_grad():
            theirs = ref_model(torch.from_numpy(b).permute(0, 3, 1, 2))
        theirs = (theirs[0] if isinstance(theirs, tuple) else theirs).permute(0, 2, 3, 1).numpy()
        max_diff = max(max_diff, float(np.abs(ours - theirs).max()))
        mse += float(((ours - theirs) ** 2).mean()) * len(b)
        n += len(b)
    ok = max_diff < opt.tolerance
    report["recon_tolerance"] = {"status": "ran", "images": n, "max_abs_diff": max_diff,
                                 "mse": mse / max(n, 1), "tolerance": opt.tolerance,
                                 "pass": bool(ok)}
    log(f"recon_tolerance: max|diff|={max_diff:.3e} over {n} images "
        f"({'PASS' if ok else 'FAIL'} at {opt.tolerance})")


def leg_rfid(opt, report, model):
    if not opt.images:
        report["rfid"] = {"status": "skipped", "reason": "--images not given"}
        return
    from .fid import fid_between, reconstruct

    try:
        feature_fn, is_proxy = _feature_fn(opt, "feature_extractor", report)
    except FileNotFoundError as e:
        report["rfid"] = {"status": "skipped", "reason": str(e)}
        return
    t0 = time.perf_counter()
    pairs = [reconstruct(model, b) for b in _images(opt, opt.images, opt.limit)]
    value = fid_between([a for a, _ in pairs], [r for _, r in pairs], feature_fn)
    entry = {"status": "ran", "images": int(sum(len(a) for a, _ in pairs)),
             "value": round(float(value), 4), "value_unrounded": float(value),
             "metric": "proxy_rfid" if is_proxy else "rfid", "variant": report["variant"],
             "seconds": time.perf_counter() - t0, **_feature_rate(feature_fn)}
    if not is_proxy and opt.ref_ckpt:
        rel = abs(value - opt.rfid_reference) / opt.rfid_reference
        entry.update({"reference": opt.rfid_reference, "rel_diff": round(float(rel), 4),
                      "pass": bool(rel <= opt.rfid_rel_tol)})
        log(f"rfid: {value:.4f} vs reference {opt.rfid_reference} (rel {rel:.2%}, "
            f"{'PASS' if rel <= opt.rfid_rel_tol else 'FAIL'}; {report['variant']})")
    else:
        log(f"rfid ({entry['metric']}): {value:.4f}")
    report["rfid"] = entry


def leg_sample_fid(opt, report):
    if not (opt.stage2_yaml and opt.stage2_ckpt and opt.images):
        report["sample_fid"] = {"status": "skipped",
                                "reason": "needs --stage2_yaml, --stage2_ckpt and --images"}
        return
    from .fid import fid_between

    sdir = opt.sample_dir or tempfile.mkdtemp(prefix="parity_samples_")
    cmd = [sys.executable, "-m", "dynamicvectorquantization_torch.sample.val",
           "--yaml_path", opt.stage2_yaml, "--model_path", opt.stage2_ckpt, "--save_path", sdir,
           "--batch_size", str(opt.batch_size), "--sample_num", str(opt.sample_num),
           "--top_k", "300", "--top_k_pos", "1024"]
    if opt.device:
        cmd += ["--device", opt.device]
    log("sampling: " + " ".join(cmd))
    t0 = time.perf_counter()
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (package_root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run(cmd, check=True, env=env, stdout=subprocess.DEVNULL)
    sample_s = time.perf_counter() - t0
    try:
        feature_fn, is_proxy = _feature_fn(opt, "sample_feature_extractor", report)
    except FileNotFoundError as e:
        report["sample_fid"] = {"status": "skipped", "reason": str(e)}
        return
    a = _images(opt, os.path.join(sdir, "numpys"), None)
    value = fid_between(a, _images(opt, opt.images, opt.limit), feature_fn)
    report["sample_fid"] = {"status": "ran", "samples": opt.sample_num,
                            "value": round(float(value), 4), "value_unrounded": float(value),
                            "metric": "proxy_fid" if is_proxy else "fid",
                            "variant": report["variant"], "sampling_seconds": sample_s,
                            "seconds": time.perf_counter() - t0, **_feature_rate(feature_fn)}
    log(f"sample_fid ({report['sample_fid']['metric']}): {value:.4f}")


def get_parser():
    p = argparse.ArgumentParser(description="stage-1 quality parity (PyTorch + CUDA)")
    p.add_argument("--yaml_path", required=True, help="stage-1 config YAML")
    p.add_argument("--ref_ckpt", default=None, help="reference stage-1 .ckpt")
    p.add_argument("--images", default=None, help="image tree or .pkl / .npy dumps (val set)")
    p.add_argument("--stage2_yaml", default=None)
    p.add_argument("--stage2_ckpt", default=None)
    p.add_argument("--sample_num", type=int, default=5000)
    p.add_argument("--sample_dir", default=None)
    p.add_argument("--reference_repo", default=os.environ.get("DQVQ_REFERENCE_REPO"))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None, help="cap rFID images")
    p.add_argument("--recon_images", type=int, default=32,
                   help="images for the recon-tolerance leg")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--tolerance", type=float, default=5e-3,
                   help="recon max|diff| tolerance (f32 accumulation order differs across "
                        "frameworks)")
    p.add_argument("--rfid_reference", type=float, default=1.6968,
                   help="the reference's published rFID")
    p.add_argument("--rfid_rel_tol", type=float, default=0.01)
    p.add_argument("--proxy_features", action="store_true",
                   help="random-projection features (plumbing only)")
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA card; cpu runs the plain-PyTorch versions")
    p.add_argument("--out", default="parity_report.json")
    return p


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from .fid import INCEPTION_VARIANT

    report = {"argv": list(sys.argv[1:] if argv is None else argv), "t_start": time.time(),
              "variant": INCEPTION_VARIANT}
    model = leg_ckpt_import(opt, report)
    leg_recon_tolerance(opt, report, model)
    leg_rfid(opt, report, model)
    leg_sample_fid(opt, report)

    ran = [k for k in LEGS if report.get(k, {}).get("status") == "ran"]
    failed = [k for k in ran if report[k].get("pass") is False]
    skipped = [k for k in LEGS if report.get(k, {}).get("status") == "skipped"]
    report["verdict"] = "FAIL" if failed else ("INCOMPLETE" if skipped else "PASS")
    report["legs_ran"] = ran
    report["legs_skipped"] = {k: report[k]["reason"] for k in skipped}
    report["t_seconds"] = time.time() - report["t_start"]
    with open(opt.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"verdict": report["verdict"], "ran": ran, "skipped": skipped,
                      "variant": report["variant"], "out": opt.out,
                      "seconds": report["t_seconds"]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
