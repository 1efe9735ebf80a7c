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
written with PIL as the JAX demo does.  ``AsyncPredictor`` runs
predictions on one worker thread in submission order: ``main`` pipelines
more than one ``--input`` through it, and ``run_on_video`` a video's frames
(``--video-input FILE`` writes ``<name>_vis.mp4``, ``--webcam`` numbered PNG
frames, both under ``--output``).  OpenCV is imported only by ``--blur`` and
the video paths.  The command runs on the first CUDA device unless
``--device cpu`` is given, and without a CUDA device it fails at once.
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import threading
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
    parser.add_argument("--webcam", action="store_true",
                        help="take inputs from the webcam (needs OpenCV)")
    parser.add_argument("--video-input", default=None,
                        help="path to a video file (needs OpenCV)")
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


class AsyncPredictor:
    """Predictions on one worker thread: ``put(image)`` enqueues (blocking
    while ``buffer_size`` tasks wait), ``get()`` returns the results in
    submission order and raises there an exception the prediction raised,
    ``__call__`` is the two in one, ``len`` the results not yet fetched;
    ``shutdown`` stops the worker."""

    class _StopToken:
        pass

    def __init__(self, predict_fn, buffer_size: int = 3):
        self._predict = predict_fn
        self._tasks: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._results: queue.Queue = queue.Queue()
        self._put_idx = self._get_idx = 0
        self._result_buf = {}
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            task = self._tasks.get()
            if isinstance(task, AsyncPredictor._StopToken):
                return
            idx, data = task
            try:
                self._results.put((idx, self._predict(data)))
            except Exception as e:  # handed to the caller at get()
                self._results.put((idx, e))

    def put(self, image):
        self._put_idx += 1
        self._tasks.put((self._put_idx, image))

    def get(self):
        self._get_idx += 1
        while self._get_idx not in self._result_buf:
            idx, res = self._results.get()
            self._result_buf[idx] = res
        res = self._result_buf.pop(self._get_idx)
        if isinstance(res, Exception):
            raise res
        return res

    def __len__(self):
        return self._put_idx - self._get_idx

    def __call__(self, image):
        self.put(image)
        return self.get()

    def shutdown(self):
        self._tasks.put(AsyncPredictor._StopToken())
        self._thread.join(timeout=10)

    @property
    def default_buffer_size(self) -> int:
        return self._tasks.maxsize


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

    def run_on_video(self, video, blur: bool = False):
        """The visualised frames (BGR) of a ``cv2.VideoCapture``-like source
        (``read() -> (ok, BGR frame)``), in order, predicted through an
        ``AsyncPredictor`` that is kept up to its buffer size."""
        pred_async = AsyncPredictor(self.run_on_image)
        pending = []

        def read():
            ok, frame = video.read()
            return frame[:, :, ::-1] if ok else None              # BGR -> RGB

        try:
            frame = read()
            while frame is not None and len(pending) < pred_async.default_buffer_size:
                pred_async.put(frame)
                pending.append(frame)
                frame = read()
            while pending:
                cur = pending.pop(0)
                pred = pred_async.get()
                if frame is not None:
                    pred_async.put(frame)
                    pending.append(frame)
                    frame = read()
                yield self.visualize(cur, pred, blur=blur)[:, :, ::-1]
        finally:
            pred_async.shutdown()


def _run_video(demo: VisualizationDemo, args: argparse.Namespace) -> int:
    """--webcam (numbered PNG frames) or --video-input (``<name>_vis.mp4``),
    both under --output; -> the number of frames written."""
    import cv2

    os.makedirs(args.output, exist_ok=True)
    writer = None
    if args.webcam:
        video = cv2.VideoCapture(0)
    else:
        if not os.path.isfile(args.video_input):
            raise FileNotFoundError(args.video_input)
        video = cv2.VideoCapture(args.video_input)
        w = int(video.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(video.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = video.get(cv2.CAP_PROP_FPS) or 30.0
        base = os.path.splitext(os.path.basename(args.video_input))[0]
        out_path = os.path.join(args.output, base + "_vis.mp4")
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h),
                                 True)
        print(f"writing {out_path}", flush=True)
    n = 0
    try:
        for frame in demo.run_on_video(video, blur=args.blur):
            n += 1
            if writer is not None:
                writer.write(frame)
            else:
                cv2.imwrite(os.path.join(args.output, f"webcam_{n:06d}.png"), frame)
    finally:
        video.release()
        if writer is not None:
            writer.release()
    print(f"processed {n} frames", flush=True)
    return n


def main(argv: Optional[Sequence[str]] = None) -> VisualizationDemo:
    args = get_parser().parse_args(argv)
    if (args.webcam or args.video_input) and args.input:
        raise SystemExit("demo: --input cannot combine with --webcam or --video-input")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA device (torch.cuda.is_available() is false); pass "
                         "--device cpu to run on the CPU")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    demo = VisualizationDemo(setup_cfg(args), device)
    if args.webcam or args.video_input:
        _run_video(demo, args)
        return demo
    paths = []
    for pat in args.input or []:
        paths += sorted(glob.glob(pat)) if any(c in pat for c in "*?[") else [pat]
    os.makedirs(args.output, exist_ok=True)

    from PIL import Image

    if len(paths) > 1:
        # the predictions run on the worker while the images are read and
        # the results drawn and written
        pred_async = AsyncPredictor(demo.run_on_image)
        t0 = time.perf_counter()
        try:
            imgs = []
            for p in paths:
                imgs.append((p, np.asarray(Image.open(p).convert("RGB"))))
                pred_async.put(imgs[-1][1])
            for p, img in imgs:
                vis = demo.visualize(img, pred_async.get(), blur=args.blur)
                out_path = os.path.join(args.output, os.path.basename(p))
                Image.fromarray(vis).save(out_path)
                print(f"{p} -> {out_path}", flush=True)
        finally:
            pred_async.shutdown()
        print(f"{len(paths)} images in {time.perf_counter() - t0:.2f}s", flush=True)
        return demo
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
