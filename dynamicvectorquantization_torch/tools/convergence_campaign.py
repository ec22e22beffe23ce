"""A long two-stage convergence campaign on synthetic structured pools
(counterpart of the JAX package's `scripts/tools/convergence_campaign.py`:
the same subcommands, flags and records).

  stage 1: the dual-grain entropy DQ-VAE at production geometry (256^2,
           ch 128, codebook 1024, bf16 towers) with the GAN loss; train rows
           (losses, adaptive disc weight, fine ratio, codebook usage and
           restart churn), validation rows with proxy rFID (a Frechet
           distance over the LPIPS VGG16 relu3_3 taps of the val images and
           their reconstructions), recon grids;
  stage 2: the p6c18 StackGPT over the frozen stage 1 (bf16 over f32
           masters), train / val cross-entropies, sampled grids;
  finalize: curve PNGs (where matplotlib imports) and `curves.json` with
           the first / last means of each curve, in `--out` only.

The data are `data/synthetic.py` pools; the entropy threshold is the pool's
median patch entropy (fine ratio 0.5). Stage 1 hands stage 2 its first-stage
weights and threshold in `<out>/stage1_state.pt` (a `torch.save` file).

    python -m dynamicvectorquantization_torch.tools.convergence_campaign stage1 --steps 10000
    python -m dynamicvectorquantization_torch.tools.convergence_campaign stage2 --steps 10000
    python -m dynamicvectorquantization_torch.tools.convergence_campaign finalize

`--device` (default: the CUDA card; `cpu` for the plain versions).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data.synthetic import build_pool, decode_pool_batch
from ..utils.logging import encode_png, make_grid, to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "convergence_campaign")


def _append_jsonl(path, rec):
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")


def _grid_png(path, images_m11, ncol=4):
    """Images in [-1, 1] (N, H, W, 3) -> one PNG grid."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(make_grid(np.asarray(images_m11), ncol=ncol))))


def synthetic_threshold(pool, n=512, device=None):
    """Median patch entropy of the pool's first `n` images: the threshold
    for fine ratio 0.5 (the percentile table's "50")."""
    from ..ops.entropy import patch_entropy

    ents = []
    with torch.no_grad():
        for i in range(0, min(n, len(pool)), 64):
            x = decode_pool_batch(pool, np.arange(i, min(i + 64, len(pool))))
            ents.append(patch_entropy(torch.from_numpy(x).to(device)).cpu().numpy().ravel())
    return float(np.median(np.concatenate(ents)))


def _frechet(feats_a, feats_b):
    from ..eval.fid import frechet_distance

    return frechet_distance(feats_a.mean(0), np.cov(feats_a, rowvar=False),
                            feats_b.mean(0), np.cov(feats_b, rowvar=False))


def dual_config(resolution, ch, z_ch, codebook, threshold=3.05):
    """The dual-grain fixed-entropy DQ-VAE at `resolution` / `ch`."""
    big = resolution >= 256
    return dict(
        encoderconfig={"target": "modules.dynamic_modules.EncoderDual.DualGrainEncoder",
                       "params": {"ch": ch, "ch_mult": [1, 1, 2, 2, 4],
                                  "num_res_blocks": 2 if big else 1,
                                  "attn_resolutions": [resolution // 16, resolution // 8],
                                  "dropout": 0.0, "in_channels": 3, "resolution": resolution,
                                  "z_channels": z_ch, "update_router": False,
                                  "router_config": _router(threshold)}},
        decoderconfig={"target": "modules.dynamic_modules.DecoderPositional.Decoder",
                       "params": {"ch": ch, "in_ch": z_ch, "out_ch": 3,
                                  "ch_mult": [1, 1, 2, 2], "num_res_blocks": 2 if big else 1,
                                  "resolution": resolution,
                                  "attn_resolutions": [resolution // 8],
                                  "latent_size": resolution // 8, "window_size": 2,
                                  "position_type": "fourier+learned"}},
        lossconfig=None,
        vqconfig={"target": "modules.vector_quantization.quantize2_mask.VectorQuantize2",
                  "params": {"codebook_size": codebook, "codebook_dim": z_ch,
                             "commitment_beta": 0.25, "decay": 0.99,
                             "restart_unused_codes": True}},
        quant_before_dim=z_ch, quant_after_dim=z_ch, image_size=resolution,
        entropy_patch_size=16)


def _router(threshold):
    return {"target": "modules.dynamic_modules.RouterDual.DualGrainFixedEntropyRouter",
            "params": {"threshold": threshold}}


def _to_m11(x_u8, device):
    return torch.as_tensor(x_u8).to(device).float() / 127.5 - 1.0


def decode_pool_batch_u8(pool, idx, flip):
    """uint8 pool rows with a per-sample horizontal flip."""
    batch = pool[idx].copy()
    batch[flip] = batch[flip, :, ::-1]
    return batch


def _merge(log_acc):
    return {k: float(np.mean([np.asarray(l[k].float().cpu()) for l in log_acc]))
            for k in log_acc[0]}


# --------------------------------------------------------------------- stage 1
def run_stage1(args):
    from ..models.dqvae import DualGrainVQModel
    from ..train.stage1 import Stage1Trainer
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "stage1_metrics.jsonl")
    open(metrics_path, "w").close()

    t0 = time.time()
    print(f"building pools train={args.pool} val={args.val} ...", flush=True)
    pool = build_pool(args.pool, args.image_size, seed=args.seed)
    val = build_pool(args.val, args.image_size, seed=args.seed + 100)
    thr = synthetic_threshold(pool, device=device)
    print(f"pools in {time.time() - t0:.0f}s; entropy threshold (r=0.5): {thr:.4f}", flush=True)

    cfg = dual_config(args.image_size, args.ch, args.z_ch, args.codebook, thr)
    cfg["compute_dtype"] = "bfloat16"
    cfg["lossconfig"] = {
        "target": "modules.losses.vqperceptual_multidisc.VQLPIPSWithDiscriminator",
        "params": {"disc_start": 1,  # the discriminator joins after one epoch
                   "disc_config": {"target": "modules.discriminator.model.NLayerDiscriminator",
                                   "params": {"input_nc": 3, "ndf": max(args.ch // 2, 16),
                                              "n_layers": 3 if args.image_size >= 256 else 2}},
                   "disc_init": True, "disc_weight_max": 0.75}}
    model = DualGrainVQModel(**cfg)
    lr = args.lr if args.lr else args.batch * 4.5e-6  # the reference LR rule, base 4.5e-6
    trainer = Stage1Trainer(model, learning_rate=lr, warmup_steps=args.warmup,
                            max_steps=args.steps, device=device, seed=args.seed)
    x0 = decode_pool_batch(pool, np.arange(1))
    trainer.init_state(torch.Generator(device=device).manual_seed(args.seed), x0)
    vgg = trainer.loss.perceptual_loss.net
    cluster = dict(model.named_buffers())["quantize.codebook.cluster_size_ema"]

    @torch.no_grad()
    def vgg_feats(x):
        return vgg(x.permute(0, 3, 1, 2).contiguous())[2].mean(dim=(2, 3)).cpu().numpy()

    def codebook_stats():
        cs = cluster.cpu().numpy()
        return {"codebook_usage_pct": float((cs >= 1.0).mean() * 100.0),
                "codebook_restarted": int((cs == 1.0).sum()),
                "cluster_size_max": float(cs.max())}

    @torch.no_grad()
    def run_eval(done):
        evs, feats_real, feats_rec = [], [], []
        for i in range(0, len(val), 64):
            vb = _to_m11(val[i:i + 64], device)
            evs.append({k: float(v) for k, v in trainer.eval_step(vb).items()})
            xr = model(vb)[0].clamp(-1, 1)
            feats_real.append(vgg_feats(vb))
            xr_u8 = torch.round((xr + 1.0) * 127.5).to(torch.uint8)
            feats_rec.append(vgg_feats(_to_m11(xr_u8, device)))
        ev = {k: float(np.mean([e[k] for e in evs])) for k in evs[0]}
        ev["proxy_rfid"] = _frechet(np.concatenate(feats_real), np.concatenate(feats_rec))
        ev["step"] = done
        _append_jsonl(metrics_path, {"split": "val", **ev})
        return ev

    @torch.no_grad()
    def save_grid(done):
        from ..utils.logging import draw_grain_map_color

        vb = torch.from_numpy(decode_pool_batch(val, np.arange(4))).to(device)
        xrec, _, grains, _, _ = model(vb)
        x_np = vb.cpu().numpy()
        rows = np.concatenate([x_np, xrec.float().cpu().numpy(),
                               draw_grain_map_color(x_np, grains.cpu().numpy())], axis=0)
        _grid_png(os.path.join(args.out, f"stage1_grid_{done:06d}.png"), rows)

    steps_per_epoch = max(1, args.pool // args.batch)
    rng = np.random.default_rng(args.seed + 7)
    done, dispatch, K, log_acc = 0, 0, args.dispatch, []
    print(f"stage1: {args.steps} steps batch={args.batch} K={K} lr={lr:.2e} "
          f"steps/epoch={steps_per_epoch}", flush=True)
    while done < args.steps:
        epoch = done // steps_per_epoch
        trainer.epoch = epoch
        idx = rng.integers(0, len(pool), (K, args.batch))
        flip = rng.random((K, args.batch)) < 0.5
        xs = np.stack([decode_pool_batch_u8(pool, idx[k], flip[k]) for k in range(K)])
        gen = torch.Generator(device=device).manual_seed(args.seed * 1000 + dispatch)
        log_acc.append(trainer.train_steps(_to_m11(xs, device), gen))
        done += K
        dispatch += 1
        if done % args.log_every < K:
            merged = _merge(log_acc)
            merged.update(codebook_stats())
            merged.update(step=done, epoch=epoch, wall_s=round(time.time() - t0, 1))
            log_acc = []
            _append_jsonl(metrics_path, {"split": "train", **merged})
            print(f"  step {done}: ae={merged['train_aeloss']:.4f} "
                  f"rec={merged['train_rec_loss']:.4f} "
                  f"disc={merged.get('train_disc_loss', float('nan')):.4f} "
                  f"usage={merged.get('codebook_usage_pct', 0):.1f}%", flush=True)
        if done % args.eval_every < K:
            ev = run_eval(done)
            print(f"  eval@{done}: rec={ev['val_rec_loss']:.4f} "
                  f"proxy_rfid={ev['proxy_rfid']:.2f}", flush=True)
        if done % args.grid_every < K:
            save_grid(done)

    ev = run_eval(done)
    save_grid(done)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if not k.startswith("loss.")}
    torch.save({"state": state, "threshold": thr, "image_size": args.image_size,
                "config": dual_config(args.image_size, args.ch, args.z_ch, args.codebook, thr)},
               os.path.join(args.out, "stage1_state.pt"))
    summary = {"stage": 1, "steps": args.steps, "batch": args.batch, "lr": lr,
               "entropy_threshold": thr, "final_val": ev,
               "wall_clock_s": round(time.time() - t0, 1), "device": str(device)}
    with open(os.path.join(args.out, "stage1_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("stage1 done:", json.dumps(summary), flush=True)
    return summary


# --------------------------------------------------------------------- stage 2
def run_stage2(args):
    from ..config.yaml_config import load_config
    from ..train.stage2 import Stage2Trainer
    from ..utils.device import resolve_device
    from ..utils.instantiate import instantiate_from_config

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "stage2_metrics.jsonl")
    open(metrics_path, "w").close()
    s1 = torch.load(os.path.join(args.out, "stage1_state.pt"), map_location="cpu",
                    weights_only=True)

    t0 = time.time()
    pool = build_pool(args.pool, args.image_size, seed=args.seed)
    val = build_pool(min(args.val, 256), args.image_size, seed=args.seed + 100)

    cfg = load_config([os.path.join(REPO, args.config)])
    params = cfg["model"]["params"]
    fs = params["first_stage_config"]["params"]
    fs["ckpt_path"] = None
    if args.max_lens != "none":
        cmax, fmax = (int(v) for v in args.max_lens.split(","))
        params["permuter_config"]["params"]["coarse_max_len"] = cmax
        params["permuter_config"]["params"]["fine_max_len"] = fmax
    # the stage-1 campaign's router and threshold
    fs["encoderconfig"]["params"]["router_config"] = _router(s1["threshold"])
    model = instantiate_from_config(cfg["model"])
    model.first_stage_model.load_state_dict(s1["state"])
    model.transformer.init_weights(torch.Generator().manual_seed(args.seed + 1))
    trainer = Stage2Trainer(model, learning_rate=args.lr or 5e-4, warmup_steps=args.warmup,
                            max_steps=args.steps, compute_dtype="bfloat16", device=device,
                            seed=args.seed)

    class _FloatPool:
        def __init__(self, p):
            self.p = p

        def __len__(self):
            return len(self.p)

        def __getitem__(self, sl):
            return self.p[sl].astype(np.float32) / 127.5 - 1.0

    z_pool = z_val = None
    if args.cached_codes:  # a frozen first stage: encode each pool once, train on streams
        t1 = time.time()
        z_pool = trainer.encode_dataset(_FloatPool(pool))
        z_val = trainer.encode_dataset(_FloatPool(val))
        print(f"encoded pools to codes in {time.time() - t1:.0f}s", flush=True)

    def run_eval(done):
        evs = []
        for i in range(0, len(val), 32):
            vb = ({k: v[i:i + 32] for k, v in z_val.items()} if args.cached_codes
                  else _to_m11(val[i:i + 32], device))
            evs.append({k: float(v) for k, v in trainer.eval_step(vb).items()})
        ev = {k: float(np.mean([e[k] for e in evs])) for k in evs[0]}
        ev["step"] = done
        _append_jsonl(metrics_path, {"split": "val", **ev})
        return ev

    @torch.no_grad()
    def run_sample(done):
        t1 = time.time()
        gen = torch.Generator(device=device).manual_seed(args.seed + done)
        with trainer.master_weights():
            toks = model.sample_from_scratch(*model.encode_to_c(8, device), generator=gen,
                                             temperature=1.0, top_k=args.top_k,
                                             top_k_pos=args.top_k_pos)
        img = model.decode_to_img(*toks).clamp(-1, 1).float().cpu().numpy()
        _grid_png(os.path.join(args.out, f"stage2_samples_{done:06d}.png"), img)
        print(f"  samples@{done} in {time.time() - t1:.0f}s", flush=True)

    rng = np.random.default_rng(args.seed + 7)
    done, dispatch, K, log_acc = 0, 0, args.dispatch, []
    print(f"stage2: {args.steps} steps batch={args.batch} K={K}", flush=True)
    while done < args.steps:
        idx = rng.integers(0, len(pool), (K, args.batch))
        if args.cached_codes:
            xs = {k: v[idx.ravel()].reshape((K, args.batch) + v.shape[1:])
                  for k, v in z_pool.items()}
        else:
            flip = rng.random((K, args.batch)) < 0.5
            xs = _to_m11(np.stack([decode_pool_batch_u8(pool, idx[k], flip[k])
                                   for k in range(K)]), device)
        gen = torch.Generator(device=device).manual_seed(args.seed * 1000 + dispatch)
        log_acc.append(trainer.train_steps(xs, gen))
        done += K
        dispatch += 1
        if done % args.log_every < K:
            merged = _merge(log_acc)
            merged.update(step=done, wall_s=round(time.time() - t0, 1))
            log_acc = []
            _append_jsonl(metrics_path, {"split": "train", **merged})
            print(f"  step {done}: loss={merged['train_loss']:.4f} "
                  f"content={merged['train_content_loss']:.4f} "
                  f"pos={merged['train_position_loss']:.4f}", flush=True)
        if done % args.eval_every < K:
            ev = run_eval(done)
            print(f"  eval@{done}: loss={ev['val_loss']:.4f}", flush=True)
        if args.sample_every and done % args.sample_every < K:
            run_sample(done)

    ev = run_eval(done)
    run_sample(done)
    summary = {"stage": 2, "steps": args.steps, "batch": args.batch, "final_val": ev,
               "wall_clock_s": round(time.time() - t0, 1), "device": str(device)}
    with open(os.path.join(args.out, "stage2_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("stage2 done:", json.dumps(summary), flush=True)
    return summary


# -------------------------------------------------------------------- finalize
def _load_rows(path):
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
    return [r for r in rows if r["split"] == "train"], [r for r in rows if r["split"] == "val"]


def curve(rows, key, k=5):
    """Means of the first and the last `k` finite values of `key`."""
    ys = [r[key] for r in rows if key in r and np.isfinite(r.get(key, np.nan))]
    return {"first": round(float(np.mean(ys[:k])), 5),
            "last": round(float(np.mean(ys[-k:])), 5)} if ys else None


def finalize(out, plot=True):
    """`<out>/curves.json` (the summaries and each curve's first / last
    means) and, with `plot` where matplotlib imports, the curve PNGs.
    Writes nothing outside `out`; returns the JSON's content."""
    s1_train, s1_val = _load_rows(os.path.join(out, "stage1_metrics.jsonl"))
    s2_train, s2_val = _load_rows(os.path.join(out, "stage2_metrics.jsonl"))
    bench = {"campaign": os.path.basename(os.path.abspath(out)), "out_dir": out}
    for n in ("stage1_summary.json", "stage2_summary.json"):
        if os.path.exists(os.path.join(out, n)):
            with open(os.path.join(out, n)) as f:
                bench[n.split("_")[0]] = json.load(f)
    bench["curves"] = {
        "stage1_train_rec_loss": curve(s1_train, "train_rec_loss"),
        "stage1_val_rec_loss": curve(s1_val, "val_rec_loss", 1),
        "stage1_proxy_rfid": curve(s1_val, "proxy_rfid", 1),
        "stage1_codebook_usage_pct": curve(s1_train, "codebook_usage_pct"),
        "stage2_train_loss": curve(s2_train, "train_loss"),
        "stage2_val_loss": curve(s2_val, "val_loss", 1),
    }
    bench["plots"] = _plot(out, s1_train, s1_val, s2_train, s2_val) if plot else "not drawn"
    with open(os.path.join(out, "curves.json"), "w") as f:
        json.dump(bench, f, indent=1)
    print(json.dumps(bench["curves"], indent=1))
    return bench


def _plot(out, s1_train, s1_val, s2_train, s2_val):
    try:
        import matplotlib
    except ImportError:
        return "not drawn: matplotlib absent"
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def panel(ax, train, val, keys):
        for k in keys:
            rows = val if k.startswith(("val_", "proxy_")) else train
            style = "--o" if rows is val else "-"
            ax.plot([r["step"] for r in rows], [r.get(k, np.nan) for r in rows], style, ms=3,
                    label=k)
        ax.set_xlabel("step"); ax.legend(fontsize=8)  # noqa: E702

    drawn = []
    if s1_train:
        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        for ax, keys in zip(axes.ravel(), [
                ("train_rec_loss", "val_rec_loss"), ("train_p_loss", "val_p_loss"),
                ("train_disc_loss", "train_g_loss", "train_d_weight"),
                ("codebook_usage_pct",), ("train_fine_ratio",), ("proxy_rfid",)]):
            panel(ax, s1_train, s1_val, keys)
        axes[1, 0].set_ylim(0, 105)
        fig.suptitle("Stage-1 DQ-VAE convergence campaign (synthetic pools)")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "stage1_curves.png"), dpi=110)
        plt.close(fig)
        drawn.append("stage1_curves.png")
    if s2_train:
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, name in zip(axes, ("loss", "content_loss", "position_loss")):
            panel(ax, s2_train, s2_val, (f"train_{name}", f"val_{name}"))
        fig.suptitle("Stage-2 DQ-Transformer convergence campaign (p6c18)")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "stage2_curves.png"), dpi=110)
        plt.close(fig)
        drawn.append("stage2_curves.png")
    return drawn


def get_parser():
    p = argparse.ArgumentParser(description="two-stage convergence campaign (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("stage1", "stage2"):
        q = sub.add_parser(name)
        q.add_argument("--steps", type=int, default=10_000)
        q.add_argument("--batch", type=int, default=16 if name == "stage1" else 8)
        q.add_argument("--dispatch", type=int, default=4, help="optimizer steps per dispatch")
        q.add_argument("--pool", type=int, default=3072)
        q.add_argument("--val", type=int, default=512)
        q.add_argument("--image-size", type=int, default=256)
        q.add_argument("--ch", type=int, default=128)
        q.add_argument("--z-ch", type=int, default=256)
        q.add_argument("--codebook", type=int, default=1024)
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--lr", type=float, default=None)
        q.add_argument("--warmup", type=int, default=500)
        q.add_argument("--log-every", type=int, default=50)
        q.add_argument("--eval-every", type=int, default=500)
        q.add_argument("--grid-every", type=int, default=2000)
        q.add_argument("--sample-every", type=int, default=4000)
        q.add_argument("--flash", action="store_true",
                       help="kept for the JAX script's command lines: on the card the port's "
                            "attention is always its fused kernel")
        q.add_argument("--cached-codes", action="store_true",
                       help="stage 2: encode the pools once, train on token streams")
        q.add_argument("--top-k", type=int, default=300)
        q.add_argument("--top-k-pos", type=int, default=256)
        q.add_argument("--config", default="configs/stage2/uncond_imagenet_p6c18.yml")
        q.add_argument("--max-lens", default="160,644",
                       help='"coarse,fine" permuter capacity or "none"')
        q.add_argument("--out", default=DEFAULT_OUT)
        q.add_argument("--device", default=None,
                       help="default: the CUDA card; cpu runs the plain versions")
    q = sub.add_parser("finalize")
    q.add_argument("--out", default=DEFAULT_OUT)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.cmd == "stage1":
        run_stage1(args)
    elif args.cmd == "stage2":
        run_stage2(args)
    else:
        finalize(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
