"""FID and rFID (counterpart of `dynamicvectorquantization_tpu/eval/fid.py`).

  * `frechet_distance(mu1, s1, mu2, s2)`: the Frechet distance between two
    Gaussians, without scipy. Of sqrtm(s1 s2) only the trace is needed, and
    tr sqrtm(s1 s2) = sum sqrt(eig(sqrt(s1) s2 sqrt(s1))), whose matrix is
    symmetric: two `eigh` in float64, eigenvalues clipped at 0, so the value
    stays real and finite where the covariances are singular (fewer samples
    than dimensions) and scipy's `sqrtm` may return complex parts. Where it is
    not finite, the JAX function's `eps` offset is added to both diagonals.
  * `compute_statistics(batches, feature_fn)`: mean and covariance of the
    features of batches of (B, H, W, 3) images in [-1, 1].
  * `inception_feature_fn(weights_path, device)`: InceptionV3 pool3 features
    through `eval/inception.py` (torchvision names and forward), weights from
    the path or `DQVQ_INCEPTION_WEIGHTS`; without a file it raises, since
    random-feature "FID" means nothing. Preprocessing as the JAX function's:
    [-1, 1] -> [0, 1], bilinear to 299^2 (`align_corners=False`), ImageNet
    mean / std. It runs on the CUDA card unless `device` names another one,
    in f32 (TF32 off); `feature_fn.calls` lists each call's images and
    seconds (`images_per_s`).
  * `fid_between(a, b, feature_fn)`, and `rfid(model, batches, feature_fn)`:
    FID between a dataset's batches and the port's DQ-VAE reconstructions of
    them (encode + decode).

`INCEPTION_VARIANT` names the extractor; every report prints it beside its
value, since published FID follows pytorch-fid's TF-Inception forward, which
this one is not.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

INCEPTION_VARIANT = ("torchvision inception_v3 pool3 (bundled trunk), ImageNet mean/std, "
                     "bilinear 299 (align_corners=False), f32")
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _trace_sqrt_product(sigma1, sigma2) -> float:
    """tr sqrtm(sigma1 sigma2) for symmetric positive semi-definite inputs."""
    w, v = np.linalg.eigh(sigma1)
    root1 = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
    m = root1 @ sigma2 @ root1
    lam = np.linalg.eigvalsh((m + m.T) * 0.5)
    return float(np.sqrt(np.clip(lam, 0.0, None)).sum())


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1).astype(np.float64), np.atleast_1d(mu2).astype(np.float64)
    sigma1 = np.atleast_2d(sigma1).astype(np.float64)
    sigma2 = np.atleast_2d(sigma2).astype(np.float64)
    diff = mu1 - mu2
    tr_covmean = _trace_sqrt_product(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = _trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def compute_statistics(batches: Iterable, feature_fn: Callable):
    """Batches of (B, H, W, 3) images in [-1, 1] -> (mu, sigma) of features."""
    feats = np.concatenate([np.asarray(feature_fn(b)) for b in batches], axis=0)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def inception_feature_fn(weights_path: str | None = None, device=None):
    """A function (B, H, W, 3) images in [-1, 1] (numpy or tensor) -> (B,
    2048) f32 numpy pool3 features."""
    from .inception import load_inception

    weights_path = weights_path or os.environ.get("DQVQ_INCEPTION_WEIGHTS")
    if not (weights_path and os.path.exists(weights_path)):
        raise FileNotFoundError(
            "InceptionV3 weights required for meaningful FID. Set "
            "DQVQ_INCEPTION_WEIGHTS to a local torchvision inception_v3 state_dict "
            "(nothing is downloaded).")
    device = resolve_device(device)
    model = load_inception(weights_path).to(device)
    mean = torch.tensor(_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(_STD, device=device).view(1, 3, 1, 1)

    def feature_fn(images_nhwc):
        t0 = time.perf_counter()
        x = torch.as_tensor(np.asarray(images_nhwc, np.float32)).to(device)
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
            x = (x.permute(0, 3, 1, 2) + 1.0) / 2.0
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
            out = model((x - mean) / std).cpu().numpy()
        feature_fn.calls.append((len(out), time.perf_counter() - t0))
        return out

    feature_fn.calls = []
    return feature_fn


def images_per_s(feature_fn):
    """The feature function's images and images/s over its calls after the
    first (which pays cuDNN's algorithm search), or over its one call."""
    calls = feature_fn.calls[1:] or feature_fn.calls
    return (sum(n for n, _ in feature_fn.calls),
            sum(n for n, _ in calls) / max(sum(s for _, s in calls), 1e-9))


def fid_between(batches_a, batches_b, feature_fn) -> float:
    mu1, s1 = compute_statistics(batches_a, feature_fn)
    mu2, s2 = compute_statistics(batches_b, feature_fn)
    return frechet_distance(mu1, s1, mu2, s2)


@torch.no_grad()
def reconstruct(model, batch):
    """One batch (B, H, W, 3) in [-1, 1], numpy, a tensor or a dict holding
    it under "image" -> (the batch, its reconstruction), f32 numpy."""
    x = batch["image"] if isinstance(batch, dict) else batch
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    return x.cpu().numpy(), model(x)[0].float().cpu().numpy()


def rfid(model, batches, feature_fn) -> float:
    """Reconstruction FID: dataset batches vs the DQ-VAE's reconstructions."""
    pairs = [reconstruct(model, b) for b in batches]
    return fid_between([a for a, _ in pairs], [r for _, r in pairs], feature_fn)
