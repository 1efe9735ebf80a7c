"""The mappers' augmentations on numpy arrays: multi-scale shortest-edge
resize, the category-constrained random crop, the SSD colour jitter, the
horizontal flip, the padding and the large-scale jitter of the COCO LSJ
recipe.

Counterpart of ``autofocusformermod_tpu/data/transforms.py``, without
OpenCV: the three OpenCV operations the JAX module calls are
written out here with OpenCV's own arithmetic, so that a sample maps to the
same bytes in both packages.

- ``resize_image``: ``cv2.resize(..., INTER_LINEAR)`` on 8-bit images: half-pixel
  centres, 11-bit fixed-point tap weights, a horizontal pass into integers
  and a vertical pass that rounds as OpenCV's vector code does.  A float
  bilinear resize (``F.interpolate``) rounded to uint8 differs from it by
  one grey level at some pixels of nearly every image.
- ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)``: source index
  ``floor(x * (1 / (dst / src)))`` in double precision.  torch's
  ``mode="nearest"`` takes the same floor with a single-precision scale and
  picks other rows or columns at some sizes.
- ``rgb_to_hsv`` / ``hsv_to_rgb``: ``cv2.COLOR_RGB2HSV`` / ``HSV2RGB`` on
  8-bit data (H in [0, 180)): the integer forward formula with OpenCV's
  division tables, and the float32 inverse with fused multiply-adds, which
  OpenCV truncates on its vector lanes (the first multiple of 32 pixels of
  each row) and rounds on the rest of the row.

Every draw from ``rng`` happens in the order of the JAX functions, so that a
mapper seeded alike crops and flips alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# OpenCV's resize weights are fixed point with this many fractional bits
_COEF_BITS = 11
# OpenCV's 8-bit RGB -> HSV divides through tables of this many fractional bits
_HSV_SHIFT = 12
# the pixels of a row that OpenCV's vector HSV -> RGB converts, in multiples
_HSV_LANES = 32


# ------------------------------------------------------------------ resizing
def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source indices (i0, i1) and fixed-point weights (w0, w1) of each
    output index, as OpenCV's resize computes them: the centre in float32
    from a double scale; along x a tap outside the image is folded into the
    edge weight (clamp_weights), along y the rows are clamped and the
    weights kept."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    if clamp_weights:
        low, high = i0 < 0, i0 >= src - 1
        f[low | high] = 0
        i0 = np.where(low, 0, np.where(high, src - 1, i0))
    one = np.float32(1 << _COEF_BITS)
    w1 = np.rint(f * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_image(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w, c) uint8 -> (H, W, c) uint8, bilinear: OpenCV's INTER_LINEAR
    on 8-bit data, bit for bit."""
    if img.shape[:2] == tuple(size_hw):
        return img.copy()
    y0, y1, b0, b1 = _linear_taps(img.shape[0], size_hw[0], clamp_weights=False)
    x0, x1, a0, a1 = _linear_taps(img.shape[1], size_hw[1], clamp_weights=True)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    # each weighted row sum to 16 bits, then round the sum off by 2 more bits
    out = ((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def resize_nearest(seg: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w, ...) -> (H, W, ...), nearest: OpenCV's INTER_NEAREST, any dtype."""
    return seg[_nearest_index(seg.shape[0], size_hw[0])][:, _nearest_index(seg.shape[1],
                                                                          size_hw[1])]


def resize_shortest_edge(img: np.ndarray, sem_seg: Optional[np.ndarray], short_edge: int,
                         max_size: int):
    """Scale so the short edge is ``short_edge``, unless the long edge would
    pass ``max_size`` (then the long edge is ``max_size``)."""
    h, w = img.shape[:2]
    scale = short_edge / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = resize_image(img, (nh, nw))
    if sem_seg is not None:
        sem_seg = resize_nearest(sem_seg, (nh, nw))
    return img, sem_seg


# -------------------------------------------------------------- the crop
def random_crop_with_category_constraint(rng: np.random.Generator, img: np.ndarray,
                                         sem_seg: Optional[np.ndarray], crop_hw: Tuple[int, int],
                                         single_category_max_area: float = 1.0,
                                         ignore_value: int = 255):
    """detectron2's RandomCrop_CategoryAreaConstraint: redraw the crop up to
    10 times while one category fills more than the given share of it."""
    h, w = img.shape[:2]
    ch, cw = min(crop_hw[0], h), min(crop_hw[1], w)

    def sample():
        y = rng.integers(0, h - ch + 1)
        x = rng.integers(0, w - cw + 1)
        return int(y), int(x)

    y, x = sample()
    if sem_seg is not None and single_category_max_area < 1.0:
        for _ in range(10):
            labels, cnt = np.unique(sem_seg[y: y + ch, x: x + cw], return_counts=True)
            cnt = cnt[labels != ignore_value]
            if len(cnt) > 1 and cnt.max() < single_category_max_area * cnt.sum():
                break
            y, x = sample()
    img = img[y: y + ch, x: x + cw]
    if sem_seg is not None:
        sem_seg = sem_seg[y: y + ch, x: x + cw]
    return img, sem_seg


# ------------------------------------------------------------- the colours
_LEVELS = np.arange(256, dtype=np.float64)
with np.errstate(divide="ignore"):
    _SDIV = np.where(_LEVELS > 0, np.rint((255 << _HSV_SHIFT) / _LEVELS), 0).astype(np.int64)
    _HDIV = np.where(_LEVELS > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * _LEVELS)), 0).astype(
        np.int64)
# which of (v, p, q, t) is b, g and r in each sixth of the hue circle
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 HSV, H in [0, 180) (OpenCV's COLOR_RGB2HSV)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    return np.stack([np.where(h < 0, h + 180, h), s, v], -1).astype(np.uint8)


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 a * b + c rounded once (exact for 8-bit data: the float32
    product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 HSV, H in [0, 180) -> uint8 RGB (OpenCV's COLOR_HSV2RGB)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = (h - sector).astype(f32)
    tab = np.stack([v, v * (f32(1) - s), v * _fma(-s, h, 1.0), v * _fma(-s, f32(1) - h, 1.0)],
                   -1)
    bgr = np.take_along_axis(tab, _SECTOR[sector.astype(np.int64) % 6], -1)
    rgb = bgr[..., ::-1] * f32(255.0)
    lanes = hsv.shape[1] // _HSV_LANES * _HSV_LANES
    tail = np.where((s == 0)[:, lanes:, None], v[:, lanes:, None] * f32(255.0), rgb[:, lanes:])
    out = np.concatenate([np.trunc(rgb[:, :lanes]), np.rint(tail)], axis=1)
    return np.clip(out, 0, 255).astype(np.uint8)


def color_aug_ssd(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """The SSD photometric distortion (detectron2 ColorAugSSDTransform) on
    uint8 RGB: brightness (+-32), then contrast (x 0.5-1.5) before or after
    saturation (x 0.5-1.5) and hue (+-18 degrees); each applied with
    probability 1/2."""
    img = img.astype(np.float32)

    def brightness(x):
        if rng.integers(2):
            x = x + rng.uniform(-32, 32)
        return x

    def contrast(x):
        if rng.integers(2):
            x = x * rng.uniform(0.5, 1.5)
        return x

    def saturation_hue(x):
        hsv = rgb_to_hsv(np.clip(x, 0, 255).astype(np.uint8)).astype(np.float32)
        if rng.integers(2):
            hsv[..., 1] *= rng.uniform(0.5, 1.5)
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-18, 18)) % 180
        hsv[..., 1] = np.clip(hsv[..., 1], 0, 255)
        return hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32)

    img = brightness(img)
    if rng.integers(2):
        img = saturation_hue(contrast(img))
    else:
        img = contrast(saturation_hue(img))
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------- flip and padding
def hflip(rng: np.random.Generator, img, sem_seg):
    if rng.integers(2):
        img = img[:, ::-1]
        if sem_seg is not None:
            sem_seg = sem_seg[:, ::-1]
    return img, sem_seg


def pad_to_size(img: np.ndarray, sem_seg: Optional[np.ndarray], size_hw: Tuple[int, int],
                img_value: int = 128, seg_value: int = 255):
    """Pad the bottom and right up to size_hw: the image with img_value, the
    label map with seg_value (the ignore label)."""
    h, w = img.shape[:2]
    ph, pw = max(0, size_hw[0] - h), max(0, size_hw[1] - w)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), constant_values=img_value)
        if sem_seg is not None:
            sem_seg = np.pad(sem_seg, ((0, ph), (0, pw)), constant_values=seg_value)
    return img, sem_seg


def pad_to_divisibility(img, sem_seg, divisibility: int, img_value=128, seg_value=255):
    h, w = img.shape[:2]
    th = -(-h // divisibility) * divisibility
    tw = -(-w // divisibility) * divisibility
    return pad_to_size(img, sem_seg, (th, tw), img_value, seg_value)


def large_scale_jitter(rng: np.random.Generator, img: np.ndarray, sem_seg: Optional[np.ndarray],
                       image_size: int, min_scale: float = 0.1, max_scale: float = 2.0,
                       seg_value: int = 255):
    """The COCO LSJ augmentation: scale the long edge to image_size times a
    random factor in [min_scale, max_scale), then a random image_size crop,
    padded to image_size x image_size (image 128, label map seg_value)."""
    scale = rng.uniform(min_scale, max_scale)
    h, w = img.shape[:2]
    ratio = image_size / max(h, w) * scale
    nh, nw = max(1, int(h * ratio)), max(1, int(w * ratio))
    img = resize_image(img, (nh, nw))
    if sem_seg is not None:
        sem_seg = resize_nearest(sem_seg, (nh, nw))
    img, sem_seg = random_crop_with_category_constraint(rng, img, sem_seg,
                                                        (image_size, image_size))
    return pad_to_size(img, sem_seg, (image_size, image_size), 128, seg_value)
