"""Evaluation metrics: Loss / InceptionScore / FID / DBI / Accuracy / MSE /
BCE / NLL / PSNR. Port of ``mcgm_tpu/evals/metrics.py``.

Per-batch metrics are torch ops on the device (``make_device_metrics``,
and the one-shot ``mse`` ... ``accuracy``); the corpus-level IS, FID and
DBI run on the host in float64 numpy, as the JAX package's do
(its FID takes ``trace(sqrtm(S1 S2))`` from two symmetric
eigendecompositions; here they are numpy's, in float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------ elementwise
def binary_cross_entropy(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with torch-style clamping of the logs at -100."""
    logp = torch.clamp(torch.log(torch.clamp(p, min=1e-44)), min=-100.0)
    log1p = torch.clamp(torch.log(torch.clamp(1.0 - p, min=1e-44)), min=-100.0)
    return -(t * logp + (1.0 - t) * log1p)


def weighted_mean(per_elem: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """Batch mean of ``per_elem [B, ...]``; with a 0/1 mask ``w [B]`` the
    masked rows are left out."""
    per_elem = per_elem.float()
    if w is None:
        return per_elem.mean()
    per_sample = per_elem.reshape(per_elem.shape[0], -1).mean(1)
    w = w.float()
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def mse(output, target) -> float:
    return float(((output.float() - target.float()) ** 2).mean())


def bce(output, target) -> float:
    """BCE of [-1, 1] images mapped to [0, 1]."""
    return float(binary_cross_entropy((output.float() + 1) / 2, (target.float() + 1) / 2).mean())


def nll(logits, target) -> float:
    """Cross-entropy over the channel-last class axis (PixelCNN logits)."""
    logp = torch.log_softmax(logits.float(), -1)
    return float(-logp.gather(-1, target.long()[..., None]).mean())


def psnr(output, target, max_val: float = 1.0) -> float:
    """In float64, as the reference computes it."""
    m = float(((output.double() - target.double()) ** 2).mean())
    return float(20 * math.log10(max_val) - 10 * math.log10(m))


def accuracy(logits, target, topk: int = 1) -> float:
    pred = torch.argsort(-logits, dim=1)[:, :topk]
    return float((pred == target[:, None]).any(1).float().mean() * 100.0)


# --------------------------------------------------------------- IS / FID
def inception_score(probs: np.ndarray, splits: int = 1) -> float:
    """``exp`` of the mean ``KL(p(y|x) || p(y))``, averaged over splits."""
    probs = np.asarray(probs, np.float64)
    N = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (N // splits): (k + 1) * (N // splits)]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(np.maximum(part, 1e-16)) - np.log(np.maximum(py, 1e-16)))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def _tr_sqrt_product_eigh(sigma1, sigma2, eps: float = 1e-10) -> float:
    """``trace(sqrtm(S1 @ S2))`` for symmetric PSD S1, S2: S1 S2 is similar
    to ``S1^1/2 S2 S1^1/2``, whose eigenvalues' square roots sum to it."""
    s1 = np.asarray(sigma1, np.float64)
    s2 = np.asarray(sigma2, np.float64)
    w, v = np.linalg.eigh(s1)
    sqrt_s1 = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
    m = sqrt_s1 @ s2 @ sqrt_s1
    ev = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sum(np.sqrt(np.clip(ev, eps, None))))


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Fréchet distance between two Gaussians, ``trace(sqrtm(S1 S2))``
    through :func:`_tr_sqrt_product_eigh`. (The JAX package's
    ``method='scipy'`` serves its offline scorer, which is not ported.)"""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"shapes differ: {mu1.shape} {mu2.shape} {sigma1.shape} {sigma2.shape}")
    diff = mu1 - mu2
    tr_covmean = _tr_sqrt_product_eigh(sigma1, sigma2)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def fid_from_features(real_feat: np.ndarray, gen_feat: np.ndarray) -> float:
    mu1, sigma1 = real_feat.mean(0), np.cov(real_feat, rowvar=False)
    mu2, sigma2 = gen_feat.mean(0), np.cov(gen_feat, rowvar=False)
    return frechet_distance(mu1, sigma1, mu2, sigma2)


def dbi(img: np.ndarray, label: np.ndarray) -> float:
    """Davies-Bouldin index on flattened pixels: the mean over clusters of
    the worst ``(s_i + s_j) / d(c_i, c_j)``, with ``s`` the mean distance to
    the centroid; centroid distances through the ``[k, k]`` gram identity."""
    x = np.asarray(img, np.float64).reshape(len(img), -1)
    label = np.asarray(label)
    classes = np.unique(label)
    if len(classes) < 2:
        raise ValueError("DBI needs >= 2 clusters")
    centroids = np.stack([x[label == c].mean(axis=0) for c in classes])
    s = np.array([np.mean(np.linalg.norm(x[label == c] - centroids[i], axis=1))
                  for i, c in enumerate(classes)])
    sq = np.sum(centroids ** 2, axis=1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (centroids @ centroids.T), 0.0))
    ratio = (s[:, None] + s[None, :]) / np.where(d == 0, np.inf, d)
    np.fill_diagonal(ratio, -np.inf)
    return float(np.mean(np.max(ratio, axis=1)))


def batched_feature_probs(feature_fn, img, batch_size: int = 256):
    """``feature_fn`` over ``img [N, H, W, C]`` (a tensor in [-1, 1]) in
    chunks; returns ``(features, probs)`` as numpy."""
    feats, probs = [], []
    for i in range(0, len(img), batch_size):
        f, p = feature_fn(img[i:i + batch_size])
        feats.append(f.cpu().numpy())
        probs.append(p.cpu().numpy())
    return np.concatenate(feats), np.concatenate(probs)


_LOSS_KEYS = {"Loss": "loss", "Loss_G": "loss_G", "Loss_D": "loss_D"}


def make_device_metrics(names):
    """``fn(batch, output) -> {name: 0-d tensor}`` for the per-batch metrics
    in ``names``, computed where the tensors are (no host transfer; the
    train loop fetches them at log points). A ``batch['w']`` mask leaves
    padded rows out of every mean."""

    def fn(batch, output):
        w = batch.get("w")
        out = {}
        for name in names:
            if name in _LOSS_KEYS:
                out[name] = output[_LOSS_KEYS[name]]
            elif name == "MSE":
                out[name] = weighted_mean((output["img"] - batch["img"]) ** 2, w)
            elif name == "BCE":
                out[name] = weighted_mean(binary_cross_entropy(
                    (output["img"].float() + 1) / 2, (batch["img"].float() + 1) / 2), w)
            elif name == "NLL":
                logp = torch.log_softmax(output["logits"].float(), -1)
                out[name] = weighted_mean(-logp.gather(-1, batch["img"].long()[..., None]), w)
            elif name == "PSNR":
                m = weighted_mean((output["img"].float() - batch["img"].float()) ** 2, w)
                out[name] = -10.0 * torch.log10(m)
            elif name == "Accuracy":
                hit = (output["label"].argmax(-1) == batch["label"]).float()
                out[name] = weighted_mean(hit, w) * 100
            else:
                raise ValueError(f"metric {name} is not a per-batch device metric")
        return out

    return fn


class Metric:
    """Metric registry: ``evaluate(names, input, output)`` computes each
    named metric from a step's input and output dicts. IS / FID need a
    feature model (``feature_fn``, see ``evals.features``) and, for FID,
    the real side's ``real_stats = (mu, sigma)`` or ``real_features``.
    ``cfg['is_splits']`` (default 1) sets the IS splits."""

    def __init__(self, cfg: dict | None = None, feature_fn=None,
                 real_features: np.ndarray | None = None,
                 real_stats: tuple | None = None, is_splits: int = 1):
        self.cfg = cfg or {}
        self.feature_fn = feature_fn
        self.real_features = real_features
        self.real_stats = real_stats
        self.is_splits = int(self.cfg.get("is_splits", is_splits))

    def evaluate(self, names, input: dict, output: dict) -> dict:
        out = {}
        cached = {}

        def feats_probs():
            if self.feature_fn is None:
                raise ValueError("IS/FID require a feature_fn")
            if "fp" not in cached:
                cached["fp"] = batched_feature_probs(self.feature_fn, output["img"])
            return cached["fp"]

        for name in names:
            if name in _LOSS_KEYS:
                out[name] = float(output[_LOSS_KEYS[name]])
            elif name == "InceptionScore":
                out[name] = inception_score(feats_probs()[1], self.is_splits)
            elif name == "FID":
                feats = feats_probs()[0]
                if self.real_stats is not None:
                    mu1, sigma1 = self.real_stats
                    out[name] = frechet_distance(mu1, sigma1, feats.mean(0),
                                                 np.cov(feats, rowvar=False))
                elif self.real_features is not None:
                    out[name] = fid_from_features(self.real_features, feats)
                else:
                    raise ValueError("FID requires real_features or real_stats")
            elif name == "DBI":
                out[name] = dbi(output["img"].cpu().numpy(), output["label"].cpu().numpy())
            elif name == "Accuracy":
                out[name] = accuracy(output["label"], input["label"])
            elif name == "MSE":
                out[name] = mse(output["img"], input["img"])
            elif name == "BCE":
                out[name] = bce(output["img"], input["img"])
            elif name == "NLL":
                out[name] = nll(output["logits"], input["img"])
            elif name == "PSNR":
                out[name] = psnr(output["img"], input["img"])
            else:
                raise ValueError(f"Not valid metric name: {name}")
        return out
