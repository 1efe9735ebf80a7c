"""The PyTorch port's demo pipeline against the JAX demo's
(``demo/demo.py``): ``AsyncPredictor`` (ordered results, ``__call__`` and
``len``, errors raised at ``get()``, shutdown), ``run_on_video`` on a fake
capture object (frames equal to the JAX demo's), the video and webcam
loops (``_run_video``, OpenCV replaced by a recording stand-in) and
``main``'s pipelined run over several images.  No model is built: the
predictions are stand-in functions."""

import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from autofocusformermod_torch import demo as tdemo

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def jax_demo():
    from demo import demo as jdemo

    return jdemo


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_async_predictor_ordered_results(impl):
    """Later items finish first; get() still returns them in order, in both
    packages."""
    cls = tdemo.AsyncPredictor if impl == "port" else jax_demo().AsyncPredictor

    def slow_square(x):
        time.sleep(0.01 * (5 - x))
        return x * x

    ap = cls(slow_square, buffer_size=8)
    for i in range(5):
        ap.put(i)
    got = [ap.get() for _ in range(5)]
    ap.shutdown()
    assert got == [0, 1, 4, 9, 16]
    assert not ap._thread.is_alive()


def test_async_predictor_call_len_and_buffer():
    ap = tdemo.AsyncPredictor(lambda x: x + 1)
    assert ap(41) == 42
    assert len(ap) == 0 and ap.default_buffer_size == 3
    ap.put(1)
    ap.put(2)
    assert len(ap) == 2
    assert [ap.get(), ap.get()] == [2, 3]
    ap.shutdown()
    assert not ap._thread.is_alive()


def test_async_predictor_raises_at_get_and_goes_on():
    """An exception of the prediction is raised at its get(), as in the JAX
    demo; the next result still comes, in order."""
    def maybe(x):
        if x == 1:
            raise ValueError("boom")
        return -x

    ap = tdemo.AsyncPredictor(maybe)
    for i in range(3):
        ap.put(i)
    assert ap.get() == 0
    with pytest.raises(ValueError, match="boom"):
        ap.get()
    assert ap.get() == -2
    ap.shutdown()


def test_async_predictor_order_under_contention():
    """500 items through a buffer of 2 with random work times and a short
    switch interval: every result arrives, in order, and the worker stops
    at shutdown."""
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 2e-4, 500)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            time.sleep(delays[i])
            return i, threading.get_ident()

        ap = tdemo.AsyncPredictor(work, buffer_size=2)
        got = []
        for i in range(500):
            ap.put(i)
            if i % 3 == 2:
                got.append(ap.get())
        while len(ap):
            got.append(ap.get())
        ap.shutdown()
    finally:
        sys.setswitchinterval(interval)
    assert [g[0] for g in got] == list(range(500))
    assert {g[1] for g in got} == {ap._thread.ident} != {threading.get_ident()}
    assert not ap._thread.is_alive()


class FakeCap:
    """A VideoCapture-like source of n 8 x 8 BGR frames, the index in the
    pixel values (tests/test_demo_async.py's)."""

    def __init__(self, n, w=8, h=8):
        self.i, self.n, self.w, self.h, self.released = 0, n, w, h, False

    def read(self):
        if self.i >= self.n:
            return False, None
        self.i += 1
        frame = np.full((self.h, self.w, 3), self.i, np.uint8)
        frame[..., 0] += 100                              # B differs from R
        return True, frame

    def get(self, prop):
        return {"w": self.w, "h": self.h, "fps": 25.0}[prop]

    def release(self):
        self.released = True


def _fake_demo(cls):
    demo = cls.__new__(cls)
    demo.nc = 4
    demo.colors = np.arange(12, dtype=np.uint8).reshape(4, 3) * 20
    demo.run_on_image = lambda img: np.full(img.shape[:2], int(img[0, 0, 0]) % 4)
    return demo


def test_run_on_video_matches_jax():
    """Seven frames through the pipeline: in order, each the JAX demo's
    frame bit for bit (BGR in, RGB to the prediction, BGR out)."""
    got = list(tdemo.VisualizationDemo.run_on_video(_fake_demo(tdemo.VisualizationDemo),
                                                    FakeCap(7)))
    jcls = jax_demo().VisualizationDemo
    want = list(jcls.run_on_video(_fake_demo(jcls), FakeCap(7)))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8 and g.shape == (8, 8, 3)
        np.testing.assert_array_equal(g, w)
        # visualize: 0.5 * img + 0.5 * colors[pred], pred = the R value % 4
        assert int(g[0, 0, 2]) == int(0.5 * (i + 1) + 0.5 * _fake_demo(
            tdemo.VisualizationDemo).colors[(i + 1) % 4][0])


@pytest.fixture()
def fake_cv2(monkeypatch):
    """OpenCV replaced by a stand-in that records what the video loop
    writes."""
    rec = {"written": [], "images": {}, "writer": None}

    class Writer:
        def __init__(self, path, fourcc, fps, size, color):
            rec["writer"] = {"path": path, "fps": fps, "size": size, "released": False}

        def write(self, frame):
            rec["written"].append(frame.copy())

        def release(self):
            rec["writer"]["released"] = True

    cv2 = types.SimpleNamespace(
        CAP_PROP_FRAME_WIDTH="w", CAP_PROP_FRAME_HEIGHT="h", CAP_PROP_FPS="fps",
        VideoCapture=lambda src: rec.setdefault("cap", FakeCap(5, 6, 4)),
        VideoWriter=Writer, VideoWriter_fourcc=lambda *c: "".join(c),
        imwrite=lambda path, frame: rec["images"].__setitem__(os.path.basename(path), frame))
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    return rec


def test_run_video_writes_the_visualised_frames(fake_cv2, tmp_path):
    """--video-input writes <name>_vis.mp4 at the capture's size and rate,
    every frame in order; --webcam numbered PNG frames; both release what
    they open."""
    demo = _fake_demo(tdemo.VisualizationDemo)
    video = tmp_path / "clip.avi"
    video.write_bytes(b"")
    args = tdemo.get_parser().parse_args(["--video-input", str(video), "--output",
                                          str(tmp_path / "out")])
    assert tdemo._run_video(demo, args) == 5
    assert fake_cv2["writer"] == {"path": str(tmp_path / "out" / "clip_vis.mp4"), "fps": 25.0,
                                  "size": (6, 4), "released": True}
    assert [int(f[0, 0, 2]) for f in fake_cv2["written"]] == [
        int(0.5 * i + 0.5 * demo.colors[i % 4][0]) for i in range(1, 6)]
    assert fake_cv2["cap"].released
    del fake_cv2["cap"]
    args = tdemo.get_parser().parse_args(["--webcam", "--output", str(tmp_path / "cam")])
    assert tdemo._run_video(demo, args) == 5
    assert sorted(fake_cv2["images"]) == [f"webcam_{i:06d}.png" for i in range(1, 6)]
    with pytest.raises(FileNotFoundError):
        tdemo._run_video(demo, tdemo.get_parser().parse_args(
            ["--video-input", str(tmp_path / "missing.mp4")]))


def test_main_pipelines_several_inputs(monkeypatch, tmp_path):
    """More than one --input runs through AsyncPredictor: the predictions on
    its worker thread, the outputs written in input order and equal to the
    synchronous path's; --input with --video-input stops."""
    from PIL import Image

    calls = []

    class Demo:
        nc, colors = 4, np.arange(12, dtype=np.uint8).reshape(4, 3) * 20

        def __init__(self, cfg, device):
            pass

        def run_on_image(self, img):
            calls.append(threading.get_ident())
            return np.full(img.shape[:2], int(img[0, 0, 0]) % 4)

        visualize = tdemo.VisualizationDemo.visualize

    monkeypatch.setattr(tdemo, "VisualizationDemo", Demo)
    monkeypatch.setattr(tdemo, "setup_cfg", lambda args: None)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"in_{i}.png"))
        Image.fromarray(np.full((5, 7, 3), 10 * i + 1, np.uint8)).save(paths[-1])
    tdemo.main(["--input", *paths, "--output", str(tmp_path / "many"), "--device", "cpu"])
    assert len(calls) == 4 and threading.get_ident() not in calls
    for i, p in enumerate(paths):
        tdemo.main(["--input", p, "--output", str(tmp_path / "one"), "--device", "cpu"])
        many = np.asarray(Image.open(tmp_path / "many" / os.path.basename(p)))
        one = np.asarray(Image.open(tmp_path / "one" / os.path.basename(p)))
        np.testing.assert_array_equal(many, one)
        v = 10 * i + 1
        assert int(many[0, 0, 0]) == int(0.5 * v + 0.5 * Demo.colors[v % 4][0])
    assert calls[-1] == threading.get_ident()
    with pytest.raises(SystemExit, match="cannot combine"):
        tdemo.main(["--input", paths[0], "--video-input", "x.mp4", "--device", "cpu"])
