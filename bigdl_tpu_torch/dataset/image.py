"""Image transformers (``bigdl_tpu/dataset/image.py``), host-side numpy.

``BytesToGreyImg``, ``GreyImgNormalizer``, ``GreyImgToSample``,
``BGRImgNormalizer``, ``RandomCropper``, ``CenterCropper``, ``HFlip``,
``BGRImgToSample`` and ``MTImageToBatch``. The random ones draw from their
``RandomGenerator``'s numpy generator in the JAX package's order, so one
seed (or the worker pool's per-element reseed) gives the same crops and
flips in both packages. ``MTImageToBatch`` computes the JAX package's
native batcher's formula, ``(v / scale - mean) * (1 / std)`` in fp32, in
numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bigdl_tpu_torch.core.rng import RandomGenerator
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class BytesToGreyImg(Transformer):
    """(bytes, label) -> (H, W) float image in [0, 255]
    (reference: ``BytesToGreyImg.scala``)."""

    def __init__(self, row: int, col: int):
        self.row, self.col = row, col

    def apply(self, it):
        for raw, label in it:
            img = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            yield img.reshape(self.row, self.col), label


class GreyImgNormalizer(Transformer):
    """(img, label) -> ((img - mean) / std, label)
    (reference: ``GreyImgNormalizer.scala``)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def apply(self, it):
        for img, label in it:
            yield (img - self.mean) / self.std, label


class GreyImgToSample(Transformer):
    """(img, label) -> Sample with (1, H, W) feature
    (reference: ``GreyImgToSample.scala``)."""

    def apply(self, it):
        for img, label in it:
            yield Sample(img[None].astype(np.float32), np.asarray(label, np.int32))


class BGRImgNormalizer(Transformer):
    """Per-channel normalize a (C, H, W) image
    (reference: ``BGRImgNormalizer.scala``)."""

    def __init__(self, means: Tuple[float, ...], stds: Tuple[float, ...]):
        self.means = np.asarray(means, np.float32).reshape(-1, 1, 1)
        self.stds = np.asarray(stds, np.float32).reshape(-1, 1, 1)

    def apply(self, it):
        for img, label in it:
            yield (img - self.means) / self.stds, label


class RandomCropper(Transformer):
    """Random crop to (crop_h, crop_w), optionally padded first
    (reference: ``BGRImgCropper.scala`` / ``BGRImgRdmCropper``)."""

    def __init__(self, crop_w: int, crop_h: int, pad: int = 0,
                 rng: Optional[RandomGenerator] = None):
        self.crop_w, self.crop_h, self.pad = crop_w, crop_h, pad
        self.rng = rng or RandomGenerator.default()

    def apply(self, it):
        np_rng = self.rng.numpy()
        for img, label in it:
            if self.pad:
                img = np.pad(
                    img, [(0, 0), (self.pad, self.pad), (self.pad, self.pad)], mode="constant"
                )
            _, h, w = img.shape
            y = np_rng.integers(0, h - self.crop_h + 1)
            x = np_rng.integers(0, w - self.crop_w + 1)
            yield img[:, y : y + self.crop_h, x : x + self.crop_w], label


class CenterCropper(Transformer):
    def __init__(self, crop_w: int, crop_h: int):
        self.crop_w, self.crop_h = crop_w, crop_h

    def apply(self, it):
        for img, label in it:
            _, h, w = img.shape
            y = (h - self.crop_h) // 2
            x = (w - self.crop_w) // 2
            yield img[:, y : y + self.crop_h, x : x + self.crop_w], label


class HFlip(Transformer):
    """Random horizontal flip (reference: ``HFlip.scala``)."""

    def __init__(self, threshold: float = 0.5, rng: Optional[RandomGenerator] = None):
        self.threshold = threshold
        self.rng = rng or RandomGenerator.default()

    def apply(self, it):
        np_rng = self.rng.numpy()
        for img, label in it:
            if np_rng.random() < self.threshold:
                img = img[..., ::-1].copy()
            yield img, label


class BGRImgToSample(Transformer):
    def apply(self, it):
        for img, label in it:
            yield Sample(np.ascontiguousarray(img, np.float32), np.asarray(label, np.int32))


def _batch_hwc_to_nchw(images: np.ndarray, mean, std,
                      scale: float = 1.0) -> np.ndarray:
    """(N, H, W, C) uint8 images -> (N, C, H, W) fp32,
    ``(v / scale - mean[c]) * (1 / std[c])``."""
    images = np.asarray(images, np.uint8)
    c = images.shape[-1]
    mean = np.broadcast_to(np.asarray(mean, np.float32), (c,))
    inv = np.float32(1.0) / np.broadcast_to(np.asarray(std, np.float32),
                                           (c,))
    x = images.transpose(0, 3, 1, 2).astype(np.float32) / np.float32(scale)
    return (x - mean[:, None, None]) * inv[:, None, None]


class MTImageToBatch(Transformer):
    """(HWC uint8 image, label) stream -> normalised NCHW fp32
    ``MiniBatch``es of ``batch_size`` (the JAX package's fused batcher;
    its ``n_threads`` is accepted and unused: numpy does the pass)."""

    elementwise = False  # N:1 batch assembly stays outside a worker pool

    def __init__(self, batch_size: int, means, stds, scale: float = 1.0,
                 n_threads: int = 4, partial_batch: bool = False):
        self.batch_size = batch_size
        self.means, self.stds, self.scale = means, stds, scale
        self.n_threads = n_threads
        self.partial_batch = partial_batch

    def apply(self, it):
        images, labels = [], []
        for img, label in it:
            images.append(np.asarray(img, np.uint8))
            labels.append(label)
            if len(images) == self.batch_size:
                yield self._batch(images, labels)
                images, labels = [], []
        if images and self.partial_batch:
            yield self._batch(images, labels)

    def _batch(self, images, labels):
        return MiniBatch(_batch_hwc_to_nchw(np.stack(images), self.means,
                                           self.stds, self.scale),
                         np.asarray(labels, np.int32))
