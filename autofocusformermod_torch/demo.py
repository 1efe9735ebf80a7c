"""Inference demo of the PyTorch port: read images, segment them, write the
visualised label maps.

    python -m autofocusformermod_torch.demo --config-file configs/...yaml \\
        --input img1.jpg "imgs/*.png" --output out_dir [--blur] [--device cpu] \\
        [--opts MODEL.WEIGHTS ckpt.pth ...]

Counterpart of ``demo/demo.py``'s ``VisualizationDemo`` and its image
loop.  ``run_on_image`` follows its order: a short-edge resize to
INPUT.MIN_SIZE_TEST (the long edge at most INPUT.MAX_SIZE_TEST), zero
padding to the size divisibility (MODEL.MASK_FORMER.SIZE_DIVISIBILITY; for
a MaskFiner cascade at least its coarsest patch), the forward, the semantic
inference, the crop, the argmax and a nearest-neighbour resize back to the
image.  The resizes are the port's numpy versions of OpenCV's
(``data/transforms.py``: the same bytes), so ``run_on_image`` and
``visualize`` need no OpenCV; the colours are the JAX demo's seeded
``color_map``.  The model is built under cfg.SEED as the Trainer builds it,
and MODEL.WEIGHTS is merged where that file exists.  Images are read and
written with PIL as the JAX demo does; OpenCV is imported for ``--blur``
alone.  The command runs on the first CUDA device unless ``--device cpu``
is given, and without a CUDA device it fails at once.  The JAX demo's
video, webcam and asynchronous paths are not ported (ROADMAP.md section 1
item 8).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import published_cfg
from .data.transforms import resize_nearest, resize_shortest_edge
from .engine.convert_checkpoint import load_reference_weights
from .models.inference import SemanticPredictor
from .models.registry import build_model, meta_architecture


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="autofocusformermod_torch demo")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--input", nargs="+", help="input images or globs")
    parser.add_argument("--webcam", action="store_true", help="not ported")
    parser.add_argument("--video-input", default=None, help="not ported")
    parser.add_argument("--output", default="demo_out")
    parser.add_argument("--blur", action="store_true",
                        help="visualize on blurred images (needs OpenCV)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    return parser


def setup_cfg(args: argparse.Namespace):
    cfg = published_cfg(args.config_file, args.opts)
    cfg.freeze()
    return cfg


def color_map(n: int) -> np.ndarray:
    """(n, 3) uint8 class colours, the JAX demo's seeded draw."""
    rng = np.random.default_rng(7)
    return rng.integers(40, 255, size=(n, 3), dtype=np.uint8)


class VisualizationDemo:
    """``run_on_image`` (RGB uint8 (h, w, 3) -> (h, w) class labels) and
    ``visualize``; the model on ``device`` (the CPU when None), or ``model``,
    one already built from ``cfg`` (a Trainer's, say), where it lies."""

    def __init__(self, cfg, device: Optional[torch.device] = None,
                 model: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(cfg.SEED)
                model = build_model(cfg)
            if cfg.MODEL.WEIGHTS and os.path.exists(cfg.MODEL.WEIGHTS):
                load_reference_weights(model, cfg.MODEL.WEIGHTS)
            model = model.to(device or torch.device("cpu"))
        self.model = model.eval()
        self.min_size, self.max_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
        self.div = cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY
        if meta_architecture(cfg).startswith("MaskFiner"):
            self.nc = cfg.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES
            # the cascade needs the canvas divisible by the coarsest patch
            self.div = max(self.div, max(cfg.MODEL.MR.PATCH_SIZES))
        else:
            self.nc = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.colors = color_map(self.nc)
        self.predictor = SemanticPredictor(self.model, self.div)

    def run_on_image(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        resized, _ = resize_shortest_edge(np.ascontiguousarray(img, dtype=np.uint8), None,
                                          self.min_size, self.max_size)
        pred = self.predictor(resized[None])[0].cpu().numpy().astype(np.int32)
        return resize_nearest(pred, (h, w))

    def visualize(self, img: np.ndarray, pred: np.ndarray, blur: bool = False) -> np.ndarray:
        if blur:
            import cv2

            base = cv2.GaussianBlur(img, (31, 31), 0)
        else:
            base = img
        overlay = self.colors[np.clip(pred, 0, self.nc - 1)]
        return (0.5 * base + 0.5 * overlay).astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> VisualizationDemo:
    args = get_parser().parse_args(argv)
    if args.webcam or args.video_input:
        raise NotImplementedError("the demo's video and webcam input is not ported "
                                  "(ROADMAP.md section 1 item 8)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA device (torch.cuda.is_available() is false); pass "
                         "--device cpu to run on the CPU")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    demo = VisualizationDemo(setup_cfg(args), device)
    paths = []
    for pat in args.input or []:
        paths += sorted(glob.glob(pat)) if any(c in pat for c in "*?[") else [pat]
    os.makedirs(args.output, exist_ok=True)

    from PIL import Image

    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"))
        t0 = time.perf_counter()
        pred = demo.run_on_image(img)
        vis = demo.visualize(img, pred, blur=args.blur)
        out_path = os.path.join(args.output, os.path.basename(p))
        Image.fromarray(vis).save(out_path)
        print(f"{p}: {time.perf_counter() - t0:.2f}s -> {out_path}", flush=True)
    return demo


if __name__ == "__main__":
    main()
