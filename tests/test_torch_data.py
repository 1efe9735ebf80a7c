"""The PyTorch port's data path against the JAX package: dataset
registration, the semantic transforms, the semantic mapper on files written
here, the loaders and the move of a batch to the device.

The JAX transforms call OpenCV; the port's write OpenCV's arithmetic out in
numpy (``data/transforms.py``), so every comparison here is exact: images,
label maps, labels and validity bit for bit, and the mapper's generator in
the same state after each sample (the same draws in the same order).
OpenCV's HSV -> RGB rounds a row's last ``width % 32`` pixels and truncates
the rest, so the colour tests use widths on both sides of 32.  The loader is
compared with one worker: with several, threads share the mapper's
generator and the assignment of draws to samples is not fixed.
"""

import os

import numpy as np
import pytest
import torch

from autofocusformermod_torch.data import datasets as tds
from autofocusformermod_torch.data import transforms as T
from autofocusformermod_torch.data.catalog import DatasetCatalog, MetadataCatalog
from autofocusformermod_torch.data.loader import TrainLoader, device_batch, eval_loader
from autofocusformermod_torch.data.mapper_semantic import MaskFormerSemanticDatasetMapper
from autofocusformermod_torch.engine.train_step import device_masks

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module")
def jt():
    """The JAX package's data modules (numpy, OpenCV and PIL; no JAX arrays)."""
    from autofocusformermod_tpu.data import datasets, loader, mapper_semantic, transforms

    return {"datasets": datasets, "loader": loader, "mapper": mapper_semantic,
            "transforms": transforms}


def write_pairs(root, sizes, seed, classes=(0, 150), name="s"):
    """JPEG images and PNG label maps (blocky classes, a band of 255)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt"), exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "img", f"{name}{i}.jpg"), quality=90)
        cells = rng.integers(*classes, (h // 16 + 1, w // 16 + 1))
        lab = cells.repeat(16, 0).repeat(16, 1)[:h, :w].astype(np.uint8)
        lab[h // 3: h // 3 + 7] = 255
        Image.fromarray(lab).save(os.path.join(root, "gt", f"{name}{i}.png"))
    return os.path.join(root, "img"), os.path.join(root, "gt")


# ------------------------------------------------------------------ datasets
def test_load_sem_seg_and_registration_match_jax(tmp_path, jt):
    for split in ("a", "b/c"):
        write_pairs(tmp_path / split, [(20, 30), (24, 16)], seed=len(split), name="x")
    (tmp_path / "a" / "img" / "unpaired.jpg").write_bytes(b"")
    (tmp_path / "a" / "gt" / "note.txt").write_text("")
    images, gts = str(tmp_path), str(tmp_path)
    got = tds.load_sem_seg(gts, images, "png", "jpg")
    assert got == jt["datasets"].load_sem_seg(gts, images, "png", "jpg")
    # pairs by relative path without extension: each image under img/ has its png under gt/
    got = tds.load_sem_seg(str(tmp_path / "b/c/gt"), str(tmp_path / "b/c/img"))
    assert [os.path.basename(d["file_name"]) for d in got] == ["x0.jpg", "x1.jpg"]
    assert all(d["sem_seg_file_name"].endswith(os.path.basename(d["file_name"])[:-3] + "png")
               for d in got)

    tds.register_sem_seg("torch_data_test", str(tmp_path / "a/img"), str(tmp_path / "a/gt"),
                         ["p", "q"], ignore_label=254)
    try:
        assert len(DatasetCatalog.get("torch_data_test")) == 2
        meta = MetadataCatalog.get("torch_data_test")
        assert (meta.stuff_classes, meta.ignore_label, meta.evaluator_type) == (["p", "q"], 254,
                                                                                "sem_seg")
        with pytest.raises(KeyError, match="already registered"):
            tds.register_sem_seg("torch_data_test", "", "", [])
    finally:
        DatasetCatalog.remove("torch_data_test")
    with pytest.raises(KeyError, match="not registered"):
        DatasetCatalog.get("torch_data_test")
    assert tds.ADE20K_SEM_SEG_CATEGORIES == jt["datasets"].ADE20K_SEM_SEG_CATEGORIES
    assert len(tds.ADE20K_SEM_SEG_CATEGORIES) == 150
    assert tds.CITYSCAPES_SEM_SEG_CATEGORIES == jt["datasets"].CITYSCAPES_SEM_SEG_CATEGORIES


def test_builtin_registration_is_lazy_and_rooted_at_the_env(monkeypatch, tmp_path):
    monkeypatch.setattr(tds, "_REGISTERED", False)
    monkeypatch.setattr(DatasetCatalog, "_registry", {})
    base = tmp_path / "ADEChallengeData2016"
    img_root, gt_root = write_pairs(tmp_path / "w", [(16, 16)], seed=0)
    os.makedirs(base / "images")
    os.makedirs(base / "annotations_detectron2")
    os.rename(img_root, base / "images" / "validation")
    os.rename(gt_root, base / "annotations_detectron2" / "validation")
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    tds.register_all_builtin()
    tds.register_all_builtin()                       # once per process
    splits = ("train", "val")
    assert set(DatasetCatalog.list()) == {
        "ade20k_sem_seg_train", "ade20k_sem_seg_val", "cityscapes_fine_sem_seg_train",
        "cityscapes_fine_sem_seg_val", "lvis_v1_train_cocofied", "lvis_v1_val_cocofied",
        *(f"coco_2017_{s}{kind}" for s in splits
          for kind in ("", "_panoptic", "_panoptic_semseg", "_stuff_sem_seg")),
        *(f"cityscapes_fine_panoptic_{s}" for s in splits)}
    assert DatasetCatalog.get("ade20k_sem_seg_train") == []     # no files: walked on get
    assert [os.path.basename(d["file_name"]) for d in DatasetCatalog.get("ade20k_sem_seg_val")] \
        == ["s0.jpg"]
    meta = MetadataCatalog.get("ade20k_sem_seg_val")
    assert meta.image_root == str(base / "images" / "validation")
    assert MetadataCatalog.get("cityscapes_fine_sem_seg_val").evaluator_type == "cityscapes_sem_seg"


# ---------------------------------------------------------------- transforms
RESIZES = [((20, 30), (20, 30)), ((200, 300), (100, 150)), ((1, 5), (3, 9)), ((5, 1), (9, 3)),
           ((3, 3), (1, 1)), ((77, 103), (512, 683)), ((96, 128), (61, 81)),
           ((48, 160), (51, 171)), ((101, 99), (50, 33)), ((33, 47), (129, 65))]


@pytest.mark.parametrize("src, dst", RESIZES)
def test_resizes_equal_opencv(src, dst):
    """Bilinear on uint8 RGB and nearest on int32 label maps, bit for bit."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(T.resize_image(img, dst),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR))
    seg = rng.integers(0, 151, src).astype(np.int32)
    np.testing.assert_array_equal(T.resize_nearest(seg, dst),
                                  cv2.resize(seg, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_resizes_equal_opencv_on_random_shapes():
    rng = np.random.default_rng(7)
    for _ in range(60):
        src = tuple(int(v) for v in rng.integers(2, 200, 2))
        dst = tuple(max(1, int(round(v * rng.uniform(0.2, 4)))) for v in src)
        img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
        np.testing.assert_array_equal(T.resize_image(img, dst), cv2.resize(img, dst[::-1]))
        seg = rng.integers(0, 256, src).astype(np.uint8)
        np.testing.assert_array_equal(T.resize_nearest(seg, dst),
                                      cv2.resize(seg, dst[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("width, step", [(45, 1), (7, 5)])
def test_hsv_conversions_equal_opencv(width, step):
    """Every 8-bit RGB -> HSV, and every HSV (H < 180) -> RGB (every
    ``step``-th), at a row width that puts pixels on OpenCV's vector lanes
    and its scalar tail (45) or on the tail only (7)."""
    levels = np.arange(0, 256, step)
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    rgb = np.stack([r, g, b], -1).astype(np.uint8).reshape(-1, 3)
    n = rgb.shape[0] // width * width
    rgb = rgb[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(T.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb.copy()
    hsv[..., 0] %= 180
    np.testing.assert_array_equal(T.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _same_draws(name, jt, args, seed, arrays=True):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(T, name)(ra, *args)
    want = getattr(jt["transforms"], name)(rb, *args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)
    assert ra.bit_generator.state == rb.bit_generator.state       # the same draws
    return got


@pytest.mark.parametrize("seed", range(6))
def test_random_transforms_match_jax(jt, seed):
    rng = np.random.default_rng(100 + seed)
    h, w = (int(v) for v in rng.integers(20, 90, 2))
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    seg = rng.integers(0, 3, (h, w)).astype(np.int64)
    seg[: h // 4] = 255
    _same_draws("random_crop_with_category_constraint", jt, (img, seg, (32, 40), 0.4, 255), seed)
    _same_draws("random_crop_with_category_constraint", jt, (img, seg, (32, 40)), seed)
    _same_draws("color_aug_ssd", jt, (img,), seed)
    _same_draws("hflip", jt, (img, seg), seed)


def test_deterministic_transforms_match_jax(jt):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (45, 70, 3)).astype(np.uint8)
    seg = rng.integers(0, 150, (45, 70)).astype(np.int64)
    for args in ((img, seg, 64, 2048), (img, seg, 30, 50), (img, None, 100, 120)):
        got, want = T.resize_shortest_edge(*args), jt["transforms"].resize_shortest_edge(*args)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])
    for got, want in ((T.pad_to_size(img, seg, (64, 64)),
                       jt["transforms"].pad_to_size(img, seg, (64, 64))),
                      (T.pad_to_divisibility(img, seg, 32, 124, 254),
                       jt["transforms"].pad_to_divisibility(img, seg, 32, 124, 254))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert T.pad_to_divisibility(img, seg, 32)[0].shape == (64, 96, 3)


# -------------------------------------------------------------------- mapper
MAPPER_KW = dict(min_size_train=(48, 64, 80), max_size_train=200, min_size_test=64,
                 max_size_test=120, crop_size=(64, 64), single_category_max_area=0.9,
                 size_divisibility=64, max_gt=12, seed=5)
SIZES = [(60, 90), (100, 40), (64, 64), (30, 170)]


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_matches_jax(tmp_path, jt, is_train):
    """Four JPEG + PNG pairs through both mappers in turn (one generator
    each): every array equal, the generators in the same state after each."""
    img_root, gt_root = write_pairs(tmp_path, SIZES, seed=1, classes=(0, 20))
    dataset = tds.load_sem_seg(gt_root, img_root)
    port = MaskFormerSemanticDatasetMapper(is_train, **MAPPER_KW)
    ref = jt["mapper"].MaskFormerSemanticDatasetMapper(is_train, **MAPPER_KW)
    for d in dataset * 2:
        got, want = port(d), ref(d)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
                assert got[k].dtype == v.dtype or k == "sem_seg", k
            else:
                assert got[k] == v, k
        assert port.rng.bit_generator.state == ref.rng.bit_generator.state
        if is_train:
            assert got["image"].shape == (64, 64, 3) and got["sem_seg_map"].dtype == np.uint8
            present = np.unique(got["sem_seg_map"])
            present = present[present != 255]
            assert list(got["labels"][got["valid"]]) == list(present[:12])
        else:
            assert min(got["image"].shape[:2]) == 64 or max(got["image"].shape[:2]) == 120


def test_mapper_readers_name_pil(monkeypatch, tmp_path):
    import sys

    from autofocusformermod_torch.data import mapper_semantic

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        mapper_semantic.read_image(str(tmp_path / "x.jpg"))
    with pytest.raises(ImportError, match="PIL"):
        mapper_semantic.read_sem_seg(str(tmp_path / "x.png"))


# ------------------------------------------------------------------- loaders
def test_train_loader_matches_jax_with_one_worker(tmp_path, jt):
    img_root, gt_root = write_pairs(tmp_path, SIZES + [(50, 50)], seed=2, classes=(0, 20))
    dataset = tds.load_sem_seg(gt_root, img_root)
    port = TrainLoader(dataset, MaskFormerSemanticDatasetMapper(True, **MAPPER_KW), 2, seed=3,
                       num_workers=1)
    ref = jt["loader"].TrainLoader(dataset,
                                   jt["mapper"].MaskFormerSemanticDatasetMapper(True, **MAPPER_KW),
                                   2, seed=3, num_workers=1)
    try:
        for _ in range(4):                            # past the first epoch of 5 samples
            got, want = next(port), next(ref)
            assert set(got) == set(want)
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k
    finally:
        port.close()
        ref.close()


def test_eval_loader_matches_jax(tmp_path, jt):
    img_root, gt_root = write_pairs(tmp_path, SIZES * 5, seed=4, classes=(0, 20))
    dataset = tds.load_sem_seg(gt_root, img_root)
    port = MaskFormerSemanticDatasetMapper(False, **MAPPER_KW)
    ref = jt["mapper"].MaskFormerSemanticDatasetMapper(False, **MAPPER_KW)
    for shard in ((0, 1), (1, 3)):
        got = list(eval_loader(dataset, port, process_index=shard[0], process_count=shard[1],
                               num_workers=2))
        want = list(jt["loader"].eval_loader(dataset, ref, process_index=shard[0],
                                             process_count=shard[1], num_workers=2))
        assert [g["file_name"] for g in got] == [w["file_name"] for w in want]
        assert len(got) == len(dataset[shard[0]::shard[1]])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])


def test_device_batch_gives_the_step_its_masks(tmp_path):
    """A mapped batch on the device, in the synthetic stream's dtypes, and
    the target masks device_masks makes of it against the JAX step's."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_tpu.parallel.train_step import _device_masks

    img_root, gt_root = write_pairs(tmp_path, SIZES, seed=5, classes=(0, 20))
    mapper = MaskFormerSemanticDatasetMapper(True, **MAPPER_KW)
    loader = TrainLoader(tds.load_sem_seg(gt_root, img_root), mapper, 3, num_workers=1)
    try:
        host = next(loader)
    finally:
        loader.close()
    batch = device_batch(host, torch.device("cpu"))
    assert set(batch) == {"image", "sem_seg_map", "labels", "valid"}
    assert [batch[k].dtype for k in ("image", "sem_seg_map", "labels", "valid")] == [
        torch.uint8, torch.uint8, torch.int64, torch.bool]
    assert batch["image"].shape == (3, 64, 64, 3) and batch["labels"].shape == (3, 12)
    assert (batch["sem_seg_map"] == 255).any()
    want = _device_masks({k: jnp.asarray(host[k]) for k in ("sem_seg_map", "labels", "valid")})
    np.testing.assert_array_equal(device_masks(batch).numpy(), np.asarray(want))


def test_train_loader_hands_a_mapper_error_to_the_caller():
    def broken(d):
        raise ValueError(f"bad sample {d['i']}")

    loader = TrainLoader([{"i": i} for i in range(3)], broken, 2, num_workers=1)
    try:
        with pytest.raises(ValueError, match="bad sample"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
