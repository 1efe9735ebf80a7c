"""The panoptic and instance dataset mappers: a panoptic PNG and its
segments, or polygon / RLE instance annotations, become per-segment binary
target masks; and the COCO LSJ instance mapper (large-scale jitter 0.1-2.0,
then a fixed square crop).

Counterpart of ``autofocusformermod_tpu/data/mapper_panoptic_instance.py``,
without OpenCV: its two OpenCV calls are written out here with OpenCV's own
arithmetic, so a sample maps to the same bytes in both packages --
``cv2.resize`` by ``transforms.resize_image`` / ``resize_nearest``, and
``cv2.fillPoly`` by ``polygons_to_mask``.

Every mapper splits into ``__call__`` (reads the files, with PIL) and
``map_arrays`` (everything after reading), which takes arrays held in
memory.  Training samples carry {'labels' (max_gt,) int32, 'masks'
(max_gt, H, W) uint8, 'valid' (max_gt,) bool}, the targets in their first
slots.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import transforms as T
from .mapper_semantic import _pil_image, read_image

# OpenCV's polygon fill keeps x in fixed point with this many fractional bits
_XY_SHIFT = 16


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG colours (..., 3) -> segment ids (panopticapi's rgb2id)."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def read_pan_seg(path: str) -> np.ndarray:
    """(h, w) int64 segment ids of a panoptic PNG."""
    return rgb2id(np.asarray(_pil_image().open(path).convert("RGB")))


# ------------------------------------------------------------- polygons
def _clip_line(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int]):
    """OpenCV's clipLine to the image [0, w-1] x [0, h-1]: (inside, p1, p2),
    intersections in double precision truncated toward zero."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _draw_line(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]) -> None:
    """OpenCV's 8-connected line (LineIterator, left to right) set to 1."""
    h, w = mask.shape
    inside = all(0 <= p[0] < w and 0 <= p[1] < h for p in (p1, p2))
    if not inside:
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    # the minor offset after k major steps: Bresenham with err = major - 2 minor
    m = (2 * minor * k + major - 1) // (2 * major) if major else k * 0
    if dy > dx:
        mask[p1[1] + sy * k, p1[0] + m] = 1
    else:
        mask[p1[1] + sy * m, p1[0] + k] = 1


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def polygons_to_mask(polygons: List, h: int, w: int) -> np.ndarray:
    """(h, w) float32 0/1: ``cv2.fillPoly(mask, polygons, 1)`` bit for bit.

    Vertices are rounded to integers (half to even); every polygon's edges
    are drawn as 8-connected lines; then one even-odd scanline fill runs
    over the edges of all polygons together (where polygons overlap, the
    fill is not their union), with x in 16-bit fixed point: at each row
    y0 <= y < y1 of an edge its crossing x, and the sorted crossings bound
    spans pairwise, each filling the pixels whose x lies inside it.  An
    edge with an end off the image crosses the rows along its clipped
    line's x (OpenCV's CollectPolyEdges and FillEdgeCollection; checked
    against OpenCV on concave, self-crossing, overlapping, one- and
    two-point and off-image polygons)."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int64) for p in polygons]
    one = 1 << _XY_SHIFT
    edges = []                                   # (y0, y1, x at y0, dx), fixed point
    for poly in pts:
        verts = [(int(x), int(y)) for x, y in poly]
        if not verts:
            continue
        prev = verts[-1]
        for cur in verts:
            _draw_line(mask, prev, cur)
            y0, y1 = prev[1], cur[1]
            c0, c1 = [prev[0] * one, y0], [cur[0] * one, y1]
            if not all(0 <= p[0] < w and 0 <= p[1] < h for p in (prev, cur)):
                # the clipped ends' x; their y too unless the clipped line is flat
                _, t0, t1 = _clip_line(w, h, prev, cur)
                flat = t0[1] == t1[1]
                c0 = [t0[0] * one, y0 if flat else t0[1]]
                c1 = [t1[0] * one, y1 if flat else t1[1]]
            if y0 != y1:
                dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
                if y0 < y1:
                    edges.append((y0, y1, c0[0] + (y0 - c0[1]) * dx, dx))
                else:
                    edges.append((y1, y0, c1[0] + (y1 - c1[1]) * dx, dx))
            prev = cur
    if len(edges) < 2:
        return mask.astype(np.float32)
    e = np.asarray(edges, np.int64)
    y0, y1, x0, dx = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= w << _XY_SHIFT):
        return mask.astype(np.float32)
    # every edge's crossing of each row y0 <= y < y1 inside the image
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(hi - lo, 0)
    if n.sum() == 0:
        return mask.astype(np.float32)
    which = np.repeat(np.arange(len(e)), n)
    ys = lo[which] + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    xs = x0[which] + (ys - y0[which]) * dx[which]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # pair consecutive crossings of a row (every row has an even count)
    first = np.ones(len(ys), bool)
    first[1:] = ys[1:] != ys[:-1]
    rank = np.arange(len(ys)) - np.maximum.accumulate(np.where(first, np.arange(len(ys)), 0))
    left = rank % 2 == 0
    # a span covers the pixels whose x lies between its two crossings
    row = ys[left]
    xa = (xs[left] + one - 1) >> _XY_SHIFT
    xb = xs[np.flatnonzero(left) + 1] >> _XY_SHIFT
    draw = (xa < w) & (xb >= 0)
    row, xa, xb = row[draw], np.maximum(xa[draw], 0), np.minimum(xb[draw], w - 1)
    # spans as +1 / -1 steps along each row, summed
    steps = np.zeros((h, w + 1), np.int32)
    np.add.at(steps, (row, xa), 1)
    np.add.at(steps, (row, xb + 1), -1)
    mask[np.cumsum(steps, axis=1)[:, :w] > 0] = 1
    return mask.astype(np.float32)


# ---------------------------------------------------------------- targets
def _pad_targets(labels: Sequence[int], masks: Sequence[np.ndarray], image_hw,
                 max_gt: int) -> Dict:
    """The first max_gt targets in max_gt slots: labels int32, masks uint8
    (the training step casts them on the device), valid bool."""
    out_labels = np.zeros((max_gt,), np.int32)
    out_masks = np.zeros((max_gt,) + tuple(image_hw), np.uint8)
    out_valid = np.zeros((max_gt,), bool)
    for i, (label, m) in enumerate(zip(labels[:max_gt], masks[:max_gt])):
        out_labels[i] = label
        out_masks[i] = m
        out_valid[i] = True
    return {"labels": out_labels, "masks": out_masks, "valid": out_valid}


class MaskFormerPanopticDatasetMapper:
    """A panoptic PNG and its segments_info -> one target per segment that
    is not crowd and keeps pixels.  Training: multi-scale shortest-edge
    resize, random crop, SSD colour jitter, flip, padding to the crop size
    (image 128, segment ids 0); testing: the shortest-edge resize, and the
    sample carries 'pan_seg' (int32 ids) and 'segments_info'.  Segment ids
    pass 255, so they stay int32 through every step."""

    def __init__(self, is_train: bool = True, *, min_size_train: Sequence[int] = (512,),
                 max_size_train: int = 2048, min_size_test: int = 512, max_size_test: int = 2048,
                 crop_enabled: bool = True, crop_size=(512, 512), color_aug_ssd: bool = True,
                 size_divisibility: int = 512, ignore_label: int = 255, max_gt: int = 100,
                 seed: int = 0):
        self.is_train = is_train
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.crop_enabled = crop_enabled
        self.crop_size = tuple(crop_size)
        self.color_aug_ssd = color_aug_ssd
        self.size_divisibility = size_divisibility
        self.ignore_label = ignore_label
        self.max_gt = max_gt
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        return cls(is_train=is_train, min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
                   max_size_train=cfg.INPUT.MAX_SIZE_TRAIN, min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                   max_size_test=cfg.INPUT.MAX_SIZE_TEST, crop_enabled=cfg.INPUT.CROP.ENABLED,
                   crop_size=cfg.INPUT.CROP.SIZE, color_aug_ssd=cfg.INPUT.COLOR_AUG_SSD,
                   size_divisibility=max(cfg.INPUT.SIZE_DIVISIBILITY, 0),
                   ignore_label=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
                   max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed)

    def __call__(self, dataset_dict: Dict) -> Dict:
        return self.map_arrays(read_image(dataset_dict["file_name"]),
                               read_pan_seg(dataset_dict["pan_seg_file_name"]), dataset_dict)

    def map_arrays(self, img: np.ndarray, pan_id: np.ndarray, dataset_dict: Dict) -> Dict:
        """Everything after reading: img (h, w, 3) uint8, pan_id (h, w) ids."""
        segments_info = dataset_dict["segments_info"]
        orig_h, orig_w = img.shape[:2]
        pan_id = pan_id.astype(np.int32)
        if self.is_train:
            short = int(self.rng.choice(self.min_size_train))
            img, pan_id = T.resize_shortest_edge(img, pan_id, short, self.max_size_train)
            if self.crop_enabled:
                img, pan_id = T.random_crop_with_category_constraint(self.rng, img, pan_id,
                                                                     self.crop_size)
            if self.color_aug_ssd:
                img = T.color_aug_ssd(self.rng, img)
            img, pan_id = T.hflip(self.rng, img, pan_id)
            target_hw = (max(self.crop_size[0], self.size_divisibility or 0),
                         max(self.crop_size[1], self.size_divisibility or 0))
            img, pan_id = T.pad_to_size(img, pan_id, target_hw, 128, 0)
        else:
            img, pan_id = T.resize_shortest_edge(img, pan_id, self.min_size_test,
                                                 self.max_size_test)
        out = {"image": np.ascontiguousarray(img.astype(np.uint8)),
               "height": dataset_dict.get("height", orig_h),
               "width": dataset_dict.get("width", orig_w),
               "image_hw": img.shape[:2],
               "file_name": dataset_dict["file_name"]}
        if not self.is_train:
            out["pan_seg"] = pan_id
            out["segments_info"] = segments_info
            return out
        labels, masks = [], []
        for seg in segments_info:
            if seg.get("iscrowd", 0):
                continue
            m = pan_id == seg["id"]
            if not m.any():
                continue
            labels.append(seg["category_id"])
            masks.append(m)
        out.update(_pad_targets(labels, masks, img.shape[:2], self.max_gt))
        return out


class MaskFormerInstanceDatasetMapper:
    """Instance annotations (polygons, RLE or arrays) -> one target per
    instance that is not crowd.  Training: multi-scale shortest-edge resize
    (bilinear image, nearest masks), random crop, SSD colour jitter, flip,
    padding to the crop size; instances the crop emptied are dropped.
    Testing: the shortest-edge resize of the image alone."""

    def __init__(self, is_train: bool = True, *, min_size_train: Sequence[int] = (512,),
                 max_size_train: int = 2048, min_size_test: int = 512, max_size_test: int = 2048,
                 crop_enabled: bool = True, crop_size=(512, 512), color_aug_ssd: bool = True,
                 size_divisibility: int = 512, max_gt: int = 100, seed: int = 0):
        self.is_train = is_train
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.crop_enabled = crop_enabled
        self.crop_size = tuple(crop_size)
        self.color_aug_ssd = color_aug_ssd
        self.size_divisibility = size_divisibility
        self.max_gt = max_gt
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        return cls(is_train=is_train, min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
                   max_size_train=cfg.INPUT.MAX_SIZE_TRAIN, min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                   max_size_test=cfg.INPUT.MAX_SIZE_TEST, crop_enabled=cfg.INPUT.CROP.ENABLED,
                   crop_size=cfg.INPUT.CROP.SIZE, color_aug_ssd=cfg.INPUT.COLOR_AUG_SSD,
                   size_divisibility=max(cfg.INPUT.SIZE_DIVISIBILITY, 0),
                   max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed)

    @staticmethod
    def _annotation_masks(annos: List[Dict], h: int, w: int) -> Tuple[List[int], List[np.ndarray]]:
        """(labels, (h, w) float32 masks) of the annotations that are not
        crowd: polygons filled as ``cv2.fillPoly`` fills them, RLE decoded,
        arrays as given."""
        labels, masks = [], []
        for a in annos:
            if a.get("iscrowd", 0):
                continue
            seg = a.get("segmentation")
            if seg is None:
                continue
            if isinstance(seg, list):
                m = polygons_to_mask(seg, h, w)
            elif isinstance(seg, dict):
                m = rle_decode(seg).astype(np.float32)
            else:
                m = np.asarray(seg, np.float32)
            labels.append(a["category_id"])
            masks.append(m)
        return labels, masks

    def __call__(self, dataset_dict: Dict) -> Dict:
        return self.map_arrays(read_image(dataset_dict["file_name"]), dataset_dict)

    def map_arrays(self, img: np.ndarray, dataset_dict: Dict) -> Dict:
        """Everything after reading: img (h, w, 3) uint8."""
        orig_h, orig_w = img.shape[:2]
        labels, masks = self._annotation_masks(dataset_dict.get("annotations", []), orig_h,
                                               orig_w)
        if self.is_train:
            short = int(self.rng.choice(self.min_size_train))
            scale = short / min(orig_h, orig_w)
            if max(orig_h, orig_w) * scale > self.max_size_train:
                scale = self.max_size_train / max(orig_h, orig_w)
            nh, nw = int(round(orig_h * scale)), int(round(orig_w * scale))
            img = T.resize_image(img, (nh, nw))
            masks = [T.resize_nearest(m, (nh, nw)) for m in masks]
            if self.crop_enabled:
                ch, cw = min(self.crop_size[0], nh), min(self.crop_size[1], nw)
                y = int(self.rng.integers(0, nh - ch + 1))
                x = int(self.rng.integers(0, nw - cw + 1))
                img = img[y: y + ch, x: x + cw]
                masks = [m[y: y + ch, x: x + cw] for m in masks]
            if self.color_aug_ssd:
                img = T.color_aug_ssd(self.rng, img)
            if self.rng.integers(2):
                img = img[:, ::-1]
                masks = [m[:, ::-1] for m in masks]
            target_hw = (max(self.crop_size[0], self.size_divisibility or 0),
                         max(self.crop_size[1], self.size_divisibility or 0))
            img, _ = T.pad_to_size(img, None, target_hw, 128)
            masks = [np.pad(m, ((0, target_hw[0] - m.shape[0]), (0, target_hw[1] - m.shape[1])))
                     for m in masks]
            keep = [i for i, m in enumerate(masks) if m.sum() > 0]
            labels, masks = [labels[i] for i in keep], [masks[i] for i in keep]
        else:
            img, _ = T.resize_shortest_edge(img, None, self.min_size_test, self.max_size_test)
        out = {"image": np.ascontiguousarray(img.astype(np.uint8)),
               "height": dataset_dict.get("height", orig_h),
               "width": dataset_dict.get("width", orig_w),
               "image_hw": img.shape[:2],
               "file_name": dataset_dict["file_name"],
               "image_id": dataset_dict.get("image_id", 0)}
        if self.is_train:
            out.update(_pad_targets(labels, masks, img.shape[:2], self.max_gt))
        return out


class COCOInstanceLSJDatasetMapper(MaskFormerInstanceDatasetMapper):
    """The COCO LSJ instance mapper (training): scale the long edge to
    image_size times a random factor in [min_scale, max_scale), flip, a
    random image_size crop and padding to image_size x image_size; testing
    as ``MaskFormerInstanceDatasetMapper``."""

    def __init__(self, is_train: bool = True, *, image_size: int = 1024, min_scale: float = 0.1,
                 max_scale: float = 2.0, max_gt: int = 100, seed: int = 0, **kw):
        super().__init__(is_train=is_train, max_gt=max_gt, seed=seed, **kw)
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        return cls(is_train=is_train, image_size=cfg.INPUT.IMAGE_SIZE,
                   min_scale=cfg.INPUT.MIN_SCALE, max_scale=cfg.INPUT.MAX_SCALE,
                   max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed)

    def map_arrays(self, img: np.ndarray, dataset_dict: Dict) -> Dict:
        orig_h, orig_w = img.shape[:2]
        labels, masks = self._annotation_masks(dataset_dict.get("annotations", []), orig_h,
                                               orig_w)
        meta = {"height": dataset_dict.get("height", orig_h),
                "width": dataset_dict.get("width", orig_w),
                "file_name": dataset_dict["file_name"],
                "image_id": dataset_dict.get("image_id", 0)}
        if not self.is_train:
            img, _ = T.resize_shortest_edge(img, None, self.min_size_test, self.max_size_test)
            return {"image": np.ascontiguousarray(img.astype(np.uint8)),
                    "image_hw": img.shape[:2], **meta}
        s = self.image_size
        ratio = s / max(orig_h, orig_w) * self.rng.uniform(self.min_scale, self.max_scale)
        nh, nw = max(1, int(orig_h * ratio)), max(1, int(orig_w * ratio))
        img = T.resize_image(img, (nh, nw))
        masks = [T.resize_nearest(m, (nh, nw)) for m in masks]
        if self.rng.integers(2):
            img = img[:, ::-1]
            masks = [m[:, ::-1] for m in masks]
        y = int(self.rng.integers(0, max(1, nh - s + 1)))
        x = int(self.rng.integers(0, max(1, nw - s + 1)))
        img = img[y: y + s, x: x + s]
        masks = [m[y: y + s, x: x + s] for m in masks]
        img, _ = T.pad_to_size(img, None, (s, s), 128)
        masks = [np.pad(m, ((0, s - m.shape[0]), (0, s - m.shape[1]))) for m in masks]
        keep = [i for i, m in enumerate(masks) if m.sum() > 0]
        out = {"image": np.ascontiguousarray(img.astype(np.uint8)), "image_hw": (s, s), **meta}
        out.update(_pad_targets([labels[i] for i in keep], [masks[i] for i in keep], (s, s),
                                self.max_gt))
        return out


# -------------------------------------------------------------------- RLE
def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE {'counts': [...] or a compressed string, 'size': [h, w]} ->
    (h, w) uint8 (runs are column-major, starting with zeros)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_rle_counts(counts.decode() if isinstance(counts, bytes)
                                               else counts)
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    flat = np.zeros(h * w + 1, np.int32)
    ones = np.arange(len(counts)) % 2 == 1
    np.add.at(flat, np.minimum(ends[ones] - counts[ones], h * w), 1)
    np.add.at(flat, np.minimum(ends[ones], h * w), -1)
    return (np.cumsum(flat[:-1]) > 0).astype(np.uint8).reshape(w, h).T


def _decode_compressed_rle_counts(s: str) -> List[int]:
    """pycocotools' compressed RLE string: 5-bit groups with a continuation
    bit and a sign bit, each count from the third on stored as the
    difference to the count two before."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts
