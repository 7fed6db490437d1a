"""Deterministic synthetic analogues of the paper's eight datasets.

The PyTorch port's own copy of the JAX package's
``data/mnist_synthetic.py`` (numpy only): the same arrays, byte for byte,
for every (dataset, split, n, seed).

The paper (Chen et al. 2015, §6) evaluates on MNIST, four Larochelle-2007
variants (ROT, BG-RAND, BG-IMG, BG-IMG-ROT) and two binary shape tasks
(RECT, CONVEX).  None is downloaded: the module generates structurally
analogous data:

- ten fixed class *prototypes* (seeded low-frequency random blobs,
  thresholded to stroke-like masks) play the role of digit classes;
- samples = prototype, jittered (shift + small rotation + pixel dropout
  + noise), 28x28 grayscale in [0, 1], flattened to 784 dims;
- ROT applies uniform rotation in [0, 2pi) (harder, as in the paper);
- BG-RAND superimposes uniform noise backgrounds;
- BG-IMG superimposes smooth structured backgrounds ("image patches");
- BG-IMG-ROT composes both;
- RECT: wide-vs-tall rectangle outlines (binary);
- CONVEX: filled convex vs non-convex (union-of-discs) shapes (binary).

Split sizes follow the paper (12k/50k variants, 60k/10k original MNIST)
but are scalable via n_train/n_test for CPU benchmarking.  Everything is a
pure function of (dataset, split, size, seed): two hosts generate
byte-identical data, which the multi-host pipeline relies on.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

IMG = 28
DIM = IMG * IMG
DATASETS = ("mnist", "basic", "rot", "bg-rand", "bg-img", "bg-img-rot",
            "rect", "convex")

PAPER_SIZES = {
    "mnist": (60000, 10000),
    "basic": (12000, 50000),
    "rot": (12000, 50000),
    "bg-rand": (12000, 50000),
    "bg-img": (12000, 50000),
    "bg-img-rot": (12000, 50000),
    "rect": (12000, 50000),
    "convex": (12000, 50000),
}


def _rng(*key_parts) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(list(key_parts)))


def _smooth_field(rng, size=IMG, cutoff=5) -> np.ndarray:
    """Low-frequency random field in [0,1] via truncated Fourier basis."""
    spec = np.zeros((size, size), np.complex128)
    spec[:cutoff, :cutoff] = (rng.standard_normal((cutoff, cutoff))
                              + 1j * rng.standard_normal((cutoff, cutoff)))
    img = np.real(np.fft.ifft2(spec, s=(size, size)))
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-9)


@functools.lru_cache(maxsize=4)
def _prototypes(seed: int = 7, n_classes: int = 10) -> np.ndarray:
    """(10, 28, 28) stroke-like class prototypes."""
    protos = []
    for c in range(n_classes):
        rng = _rng(seed, 101, c)
        field = _smooth_field(rng, cutoff=6)
        # threshold band -> stroke-like mask, distinct per class
        lo = 0.40 + 0.02 * (c % 5)
        mask = ((field > lo) & (field < lo + 0.22)).astype(np.float64)
        protos.append(mask)
    return np.stack(protos)


def _rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """Nearest-neighbour rotation about the image centre."""
    c = (IMG - 1) / 2.0
    ys, xs = np.mgrid[0:IMG, 0:IMG]
    ca, sa = np.cos(angle), np.sin(angle)
    sy = ca * (ys - c) - sa * (xs - c) + c
    sx = sa * (ys - c) + ca * (xs - c) + c
    syi = np.clip(np.rint(sy).astype(int), 0, IMG - 1)
    sxi = np.clip(np.rint(sx).astype(int), 0, IMG - 1)
    out = img[syi, sxi]
    out[(sy < -0.5) | (sy > IMG - 0.5) | (sx < -0.5) | (sx > IMG - 0.5)] = 0
    return out


def _digit_sample(rng, proto: np.ndarray, max_angle: float) -> np.ndarray:
    angle = rng.uniform(-max_angle, max_angle)
    img = _rotate(proto, angle)
    # small translation
    dy, dx = rng.integers(-2, 3, size=2)
    img = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    # stroke dropout + additive noise
    img = img * (rng.random(img.shape) > 0.08)
    img = img + 0.12 * rng.standard_normal(img.shape)
    return np.clip(img, 0.0, 1.0)


def _digits(dataset: str, split: str, n: int, seed: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    rot = dataset in ("rot", "bg-img-rot")
    bg_rand = dataset == "bg-rand"
    bg_img = dataset in ("bg-img", "bg-img-rot")
    protos = _prototypes()
    rng = _rng(seed, hashs(dataset), hashs(split))
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    xs = np.empty((n, IMG, IMG), np.float32)
    max_angle = np.pi if rot else 0.25
    for i in range(n):
        img = _digit_sample(rng, protos[labels[i]], max_angle)
        if bg_rand:
            bg = rng.random((IMG, IMG))
            img = np.where(img > 0.25, img, 0.8 * bg)
        elif bg_img:
            bg = _smooth_field(rng, cutoff=4)
            img = np.where(img > 0.25, img, 0.85 * bg)
        xs[i] = img
    return xs.reshape(n, DIM), labels


def _rect(split: str, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = _rng(seed, hashs("rect"), hashs(split))
    xs = np.zeros((n, IMG, IMG), np.float32)
    labels = np.empty((n,), np.int32)
    for i in range(n):
        while True:
            h = rng.integers(4, 25)
            w = rng.integers(4, 25)
            if h != w:
                break
        y0 = rng.integers(0, IMG - h)
        x0 = rng.integers(0, IMG - w)
        img = np.zeros((IMG, IMG), np.float32)
        img[y0:y0 + h, x0] = 1.0
        img[y0:y0 + h, x0 + w - 1] = 1.0
        img[y0, x0:x0 + w] = 1.0
        img[y0 + h - 1, x0:x0 + w] = 1.0
        xs[i] = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        labels[i] = int(h > w)   # 1 = tall, 0 = wide
    return xs.reshape(n, DIM), labels


def _convex(split: str, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = _rng(seed, hashs("convex"), hashs(split))
    ys, xs_grid = np.mgrid[0:IMG, 0:IMG]
    xs = np.zeros((n, IMG, IMG), np.float32)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    for i in range(n):
        if labels[i]:  # convex: one filled disc (intersection of halfplanes)
            cy, cx = rng.uniform(8, 20, size=2)
            r = rng.uniform(4, 9)
            img = (((ys - cy) ** 2 + (xs_grid - cx) ** 2) <= r * r)
        else:          # non-convex: union of two separated discs
            while True:
                c1 = rng.uniform(6, 22, size=2)
                c2 = rng.uniform(6, 22, size=2)
                if np.hypot(*(c1 - c2)) > 9:
                    break
            r1, r2 = rng.uniform(3.5, 6.5, size=2)
            img = ((((ys - c1[0]) ** 2 + (xs_grid - c1[1]) ** 2) <= r1 * r1)
                   | (((ys - c2[0]) ** 2 + (xs_grid - c2[1]) ** 2) <= r2 * r2))
        xs[i] = np.clip(img.astype(np.float32)
                        + 0.05 * rng.standard_normal(img.shape), 0, 1)
    return xs.reshape(n, DIM), labels


def hashs(s: str) -> int:
    """Deterministic small string hash (builtin hash is process-salted)."""
    import zlib
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def num_classes(dataset: str) -> int:
    return 2 if dataset in ("rect", "convex") else 10


def load(dataset: str, split: str = "train", n: int | None = None,
         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n, 784) float32 in [0,1], y (n,) int32), deterministic."""
    if dataset not in DATASETS:
        raise KeyError(f"unknown dataset {dataset!r}; known {DATASETS}")
    if n is None:
        n = PAPER_SIZES[dataset][0 if split == "train" else 1]
    if dataset == "rect":
        return _rect(split, n, seed)
    if dataset == "convex":
        return _convex(split, n, seed)
    return _digits(dataset, split, n, seed)
