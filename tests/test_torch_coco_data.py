"""The PyTorch port's panoptic, instance and COCO data path against the JAX
package and OpenCV: ``polygons_to_mask`` against ``cv2.fillPoly``, the
large-scale jitter, the panoptic, instance and both LSJ mappers (training
and test), the COCO and Cityscapes JSON loaders and registrations, the
mapper dispatch, and the two presets against their merged yamls.

Every comparison is exact: masks bit for bit, images, ids, labels and
validity equal, and each mapper's generator in the same state after each
sample (the same draws in the same order).  OpenCV's nearest resize hands
int64 label maps back as int32; the port keeps the dtype, so the LSJ label
maps are compared by value.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from autofocusformermod_torch.data import transforms as T
from autofocusformermod_torch.data.datasets_coco import (load_cityscapes_panoptic,
                                                         load_coco_instances, load_coco_panoptic)
from autofocusformermod_torch.data.mapper_panoptic_instance import (
    COCOInstanceLSJDatasetMapper, MaskFormerInstanceDatasetMapper,
    MaskFormerPanopticDatasetMapper, polygons_to_mask, rgb2id)
from autofocusformermod_torch.data.mapper_semantic import (COCOSemanticLSJDatasetMapper,
                                                           MaskFormerSemanticDatasetMapper,
                                                           stuff_remap_lut)
from autofocusformermod_torch.evaluation.instance_evaluation import rle_encode

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jd():
    """The JAX package's data modules (numpy, OpenCV and PIL; no JAX arrays)."""
    from autofocusformermod_tpu.data import (datasets_coco, mapper_panoptic_instance,
                                             mapper_semantic, transforms)

    return SimpleNamespace(coco=datasets_coco, pi=mapper_panoptic_instance,
                           sem=mapper_semantic, transforms=transforms)


# ------------------------------------------------------------------ polygons
def _fill(polys, h, w):
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
                        for p in polys], 1)
    return mask.astype(np.float32)


POLYGONS = {
    "triangle": ([[2, 3, 25.4, 6, 10, 27.5]], 30, 32),
    "concave": ([[2, 2, 28, 2, 28, 28, 15, 10, 2, 28]], 32, 32),
    "self_touching": ([[2, 2, 20, 2, 11, 11, 20, 20, 2, 20, 11, 11]], 24, 24),
    "self_crossing": ([[1, 1, 22, 20, 22, 1, 1, 20]], 24, 24),
    "overlapping": ([[2, 2, 20, 2, 20, 20, 2, 20], [10, 10, 28, 10, 28, 28, 10, 28]], 32, 32),
    "nested": ([[1, 1, 30, 1, 30, 30, 1, 30], [8, 8, 22, 8, 22, 22, 8, 22]], 32, 32),
    "two_points": ([[3, 4, 20, 17]], 24, 24),
    "one_point": ([[5.5, 6.5]], 12, 12),
    "flat": ([[2, 5, 20, 5, 11, 5]], 12, 24),
    "off_image": ([[-10, -5, 40, 3, 35, 50, -8, 30]], 30, 32),
    "off_left": ([[-4, 30, -2, -6, 0, 11, 18, 2, -3, 17, 11, -1, 5, 11]], 24, 15),
    "outside": ([[-20, -20, -5, -20, -5, -5]], 16, 16),
    "half_vertices": ([[0.5, 1.5, 12.5, 2.5, 7.5, 14.5]], 16, 16),
}


@pytest.mark.parametrize("case", sorted(POLYGONS))
def test_polygons_to_mask_equals_opencv(case):
    polys, h, w = POLYGONS[case]
    got = polygons_to_mask(polys, h, w)
    assert got.dtype == np.float32 and got.shape == (h, w)
    np.testing.assert_array_equal(got, _fill(polys, h, w))


@pytest.mark.parametrize("spread", [(0.0, 1.0), (-0.3, 1.3), (-2.0, 3.0)])
def test_polygons_to_mask_equals_opencv_on_random_polygons(spread):
    """Random vertex sets (self-crossing, one to eight vertices, one to
    three polygons a call), inside the image, around its edges and far off."""
    rng = np.random.default_rng(int(10 * spread[1]))
    for _ in range(300):
        h, w = int(rng.integers(5, 50)), int(rng.integers(5, 50))
        polys = [list((rng.uniform(*spread, (int(rng.integers(1, 9)), 2)) * [w, h]).reshape(-1))
                 for _ in range(int(rng.integers(1, 4)))]
        np.testing.assert_array_equal(polygons_to_mask(polys, h, w), _fill(polys, h, w))


def test_polygons_to_mask_equals_opencv_at_coco_sizes(jd):
    rng = np.random.default_rng(3)
    for h, w in [(480, 640), (427, 640), (640, 480)]:
        for _ in range(6):
            n = int(rng.integers(3, 60))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = rng.uniform(5, 300) * rng.uniform(0.3, 1.0, n)
            c = rng.uniform(-0.1, 1.1, 2) * [w, h]
            poly = [list(np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)],
                                  1).reshape(-1))]
            got = polygons_to_mask(poly, h, w)
            np.testing.assert_array_equal(got, jd.pi.polygons_to_mask(poly, h, w))


# ---------------------------------------------------------------- transforms
@pytest.mark.parametrize("hw", [(48, 64), (64, 40), (30, 30)])
@pytest.mark.parametrize("with_seg", [True, False])
def test_large_scale_jitter_matches_jax(jd, hw, with_seg):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    seg = rng.integers(0, 300, hw).astype(np.int32) if with_seg else None
    for seed in range(6):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        gi, gs = T.large_scale_jitter(a, img, seg, 56, 0.1, 2.0, seg_value=254)
        wi, ws = jd.transforms.large_scale_jitter(b, img, seg, 56, 0.1, 2.0, seg_value=254)
        np.testing.assert_array_equal(gi, wi)
        assert gi.shape == (56, 56, 3) and gi.dtype == np.uint8
        if with_seg:
            np.testing.assert_array_equal(gs, ws)
            assert gs.dtype == ws.dtype == np.int32
        assert a.bit_generator.state == b.bit_generator.state


def test_rgb2id_matches_jax(jd):
    c = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(rgb2id(c), jd.pi.rgb2id(c))


# ------------------------------------------------------------------- mappers
def _write(path, arr, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, **kw)


def panoptic_files(root, sizes, seed=0):
    """Images (JPEG) and panoptic PNGs: 8-pixel blocks of segments with ids
    past 255 (stuff, things, a crowd segment), and their segments_info."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        _write(os.path.join(root, "img", f"{i}.jpg"), img, quality=90)
        segs = rng.integers(0, 6, (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)[:h, :w]
        ids = np.where(segs == 0, 0, segs * 1000 + 17).astype(np.int64)
        pan = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        _write(os.path.join(root, "pan", f"{i}.png"), pan)
        info = [{"id": int(k) * 1000 + 17, "category_id": int(rng.integers(0, 19)),
                 "iscrowd": int(k == 5)} for k in range(1, 6)]
        info.append({"id": 999, "category_id": 3, "iscrowd": 0})       # not in the map
        out.append({"file_name": os.path.join(root, "img", f"{i}.jpg"),
                    "pan_seg_file_name": os.path.join(root, "pan", f"{i}.png"),
                    "image_id": i, "height": h, "width": w, "segments_info": info})
    return out


def _coco_rle(mask):
    """COCO's uncompressed RLE of an (h, w) bool mask."""
    return {"size": list(mask.shape), "counts": [int(c) for c in rle_encode(mask)["counts"]]}


def instance_files(root, sizes, seed=0):
    """Images and instance annotations: polygons (one off the image),
    uncompressed RLE, a crowd polygon and a crowd-free image's none."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        _write(os.path.join(root, "img", f"{i}.png"), img)
        annos = []
        for k in range(4):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            r = rng.uniform(4, min(h, w) / 2)
            poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).reshape(-1)
            annos.append({"category_id": int(rng.integers(0, 80)), "iscrowd": int(k == 3),
                          "segmentation": [list(poly)]})
        m = np.zeros((h, w), bool)
        m[h // 4: h // 2, w // 3: w // 2] = True
        annos.append({"category_id": 7, "iscrowd": 0, "segmentation": _coco_rle(m)})
        out.append({"file_name": os.path.join(root, "img", f"{i}.png"), "image_id": 40 + i,
                    "height": h, "width": w, "annotations": annos})
    return out


def _assert_samples_equal(got, want):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v or (tuple(got[k]) == tuple(v)), k


PAN_KW = dict(min_size_train=[40, 48, 64], max_size_train=128, min_size_test=48,
              max_size_test=96, crop_size=(32, 48), size_divisibility=0, max_gt=6)


@pytest.mark.parametrize("is_train", [True, False])
def test_panoptic_mapper_matches_jax(jd, tmp_path, is_train):
    files = panoptic_files(tmp_path, [(40, 60), (56, 48), (64, 96)])
    port = MaskFormerPanopticDatasetMapper(is_train, seed=3, **PAN_KW)
    ref = jd.pi.MaskFormerPanopticDatasetMapper(is_train, seed=3, **PAN_KW)
    for _ in range(2):
        for d in files:
            got, want = port(d), ref(d)
            _assert_samples_equal(got, want)
            assert port.rng.bit_generator.state == ref.rng.bit_generator.state
            if is_train:
                assert got["image"].shape == (32, 48, 3) and got["masks"].dtype == np.uint8
                assert 0 < got["valid"].sum() <= 4
            else:
                assert got["pan_seg"].dtype == np.int32 and got["pan_seg"].max() > 255


INST_KW = dict(min_size_train=[40, 56], max_size_train=100, min_size_test=48, max_size_test=96,
               crop_size=(40, 40), size_divisibility=48, max_gt=5)


@pytest.mark.parametrize("is_train", [True, False])
def test_instance_mapper_matches_jax(jd, tmp_path, is_train):
    files = instance_files(tmp_path, [(40, 60), (50, 44), (33, 70)])
    port = MaskFormerInstanceDatasetMapper(is_train, seed=5, **INST_KW)
    ref = jd.pi.MaskFormerInstanceDatasetMapper(is_train, seed=5, **INST_KW)
    for _ in range(2):
        for d in files:
            got, want = port(d), ref(d)
            _assert_samples_equal(got, want)
            assert port.rng.bit_generator.state == ref.rng.bit_generator.state
            if is_train:
                assert got["masks"].shape == (5, 48, 48) and got["valid"].any()


@pytest.mark.parametrize("is_train", [True, False])
def test_coco_instance_lsj_mapper_matches_jax(jd, tmp_path, is_train):
    files = instance_files(tmp_path, [(48, 64), (64, 48), (43, 64)], seed=1)
    kw = dict(image_size=64, min_scale=0.1, max_scale=2.0, max_gt=6)
    port = COCOInstanceLSJDatasetMapper(is_train, seed=9, **kw)
    ref = jd.pi.COCOInstanceLSJDatasetMapper(is_train, seed=9, **kw)
    scales = []
    for _ in range(4):
        for d in files:
            got, want = port(d), ref(d)
            _assert_samples_equal(got, want)
            assert port.rng.bit_generator.state == ref.rng.bit_generator.state
            if is_train:
                assert got["image"].shape == (64, 64, 3) and got["image_hw"] == (64, 64)
                scales.append(int((got["image"] != 128).any(-1).sum()))
    if is_train:
        assert min(scales) < 64 * 64 // 4 and max(scales) == 64 * 64     # shrunk and cropped


def test_coco_semantic_lsj_mapper_and_remap_match_jax(jd, tmp_path):
    rng = np.random.default_rng(2)
    files = []
    for i, (h, w) in enumerate([(40, 56), (56, 40)]):
        _write(str(tmp_path / "img" / f"{i}.jpg"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        lab = rng.integers(0, 183, (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)[:h, :w]
        lab[: h // 5] = 255
        _write(str(tmp_path / "gt" / f"{i}.png"), lab.astype(np.uint8))
        files.append({"file_name": str(tmp_path / "img" / f"{i}.jpg"),
                      "sem_seg_file_name": str(tmp_path / "gt" / f"{i}.png")})
    mapping = {k - 1: i for i, k in enumerate(jd.coco.COCO_STUFF_171_IDS)}
    lut = stuff_remap_lut(mapping)
    np.testing.assert_array_equal(lut, jd.sem.stuff_remap_lut(mapping))
    kw = dict(image_size=48, min_scale=0.5, max_scale=1.5, size_divisibility=32, max_gt=20,
              dataset_id_remap=lut)
    port = COCOSemanticLSJDatasetMapper(seed=4, **kw)
    ref = jd.sem.COCOSemanticLSJDatasetMapper(seed=4, **kw)
    for _ in range(3):
        for d in files:
            _assert_samples_equal(port(d), ref(d))
            assert port.rng.bit_generator.state == ref.rng.bit_generator.state
    # the shortest-edge semantic mapper remaps too (its eval side)
    sem_kw = dict(min_size_test=48, max_size_test=96, dataset_id_remap=lut)
    for d in files:
        got = MaskFormerSemanticDatasetMapper(False, **sem_kw)(d)
        want = jd.sem.MaskFormerSemanticDatasetMapper(False, **sem_kw)(d)
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
        assert (got["sem_seg"] == 255).any() and got["sem_seg"].max() <= 255


# ----------------------------------------------------------- JSON loaders
def test_coco_loaders_match_jax(jd, tmp_path):
    cats = [{"id": 1, "name": "a"}, {"id": 5, "name": "b"}, {"id": 3, "name": "c"}]
    images = [{"id": 7, "file_name": "x.jpg", "height": 4, "width": 6},
              {"id": 2, "file_name": "y.png", "height": 5, "width": 3}]
    inst = {"categories": cats, "images": images, "annotations": [
        {"image_id": 7, "category_id": 5, "segmentation": [[0, 0, 3, 0, 3, 3]], "iscrowd": 0,
         "bbox": [0, 0, 3, 3]},
        {"image_id": 7, "category_id": 3, "segmentation": {"size": [4, 6], "counts": [3, 4, 17]},
         "iscrowd": 1},
        {"image_id": 2, "category_id": 1, "segmentation": [[0, 0, 2, 0, 2, 2]]}]}
    pan = {"categories": cats, "images": images, "annotations": [
        {"image_id": 2, "file_name": "y.png", "segments_info": [
            {"id": 300, "category_id": 5, "iscrowd": 1}, {"id": 7, "category_id": 1}]},
        {"image_id": 7, "file_name": "x.png", "segments_info": []}]}
    (tmp_path / "inst.json").write_text(json.dumps(inst))
    (tmp_path / "pan.json").write_text(json.dumps(pan))
    got = load_coco_instances(str(tmp_path / "inst.json"), "imgs")
    assert got == jd.coco.load_coco_instances(str(tmp_path / "inst.json"), "imgs")
    assert [a["category_id"] for a in got[0]["annotations"]] == [2, 1]      # 1, 3, 5 -> 0, 1, 2
    got = load_coco_panoptic(str(tmp_path / "pan.json"), "imgs", "pans")
    assert got == jd.coco.load_coco_panoptic(str(tmp_path / "pan.json"), "imgs", "pans")
    assert got[0]["file_name"].endswith("y.jpg")


def test_cityscapes_panoptic_loader_matches_jax(jd, tmp_path):
    data = {"annotations": [
        {"image_id": "frankfurt_000000_000294", "file_name": "frankfurt_000000_000294_gtFine_panoptic.png",
         "segments_info": [{"id": 7, "category_id": 7, "iscrowd": 0, "area": 5},
                           {"id": 26001, "category_id": 26, "iscrowd": 0},
                           {"id": 26, "category_id": 26, "iscrowd": 1},
                           {"id": 3, "category_id": 3, "iscrowd": 0}]}]}   # 3: no train id
    (tmp_path / "cs.json").write_text(json.dumps(data))
    args = ("leftImg8bit/val", str(tmp_path / "cs.json"), "gtFine/panoptic")
    got = load_cityscapes_panoptic(*args)
    assert got == jd.coco.load_cityscapes_panoptic(*args)
    assert [s["category_id"] for s in got[0]["segments_info"]] == [0, 13, 13]
    assert got[0]["file_name"].endswith("frankfurt/frankfurt_000000_000294_leftImg8bit.png")


def test_builtin_registrations_match_jax(jd):
    from autofocusformermod_tpu.data import catalog as jcat
    from autofocusformermod_tpu.data.datasets import register_all_builtin as jax_register

    from autofocusformermod_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from autofocusformermod_torch.data.datasets import register_all_builtin

    register_all_builtin()
    jax_register()
    names = ["coco_2017_train", "coco_2017_val", "coco_2017_val_panoptic",
             "lvis_v1_val_cocofied", "cityscapes_fine_panoptic_train",
             "cityscapes_fine_panoptic_val", "coco_2017_val_stuff_sem_seg",
             "coco_2017_train_panoptic_semseg"]
    for name in names:
        assert name in DatasetCatalog.list() and name in jcat.DatasetCatalog.list(), name
        got, want = MetadataCatalog.get(name).as_dict(), jcat.MetadataCatalog.get(name).as_dict()
        assert {k: v for k, v in got.items() if k != "name"} == {
            k: v for k, v in want.items() if k != "name"}, name
    assert MetadataCatalog.get("cityscapes_fine_panoptic_val").evaluator_type == \
        "cityscapes_panoptic_seg"


# ------------------------------------------------------- the mapper dispatch
MAPPERS = {"mask_former_semantic": ("MaskFormerSemanticDatasetMapper",) * 2,
           "coco_semantic": ("MaskFormerSemanticDatasetMapper",) * 2,
           "coco_semantic2": ("COCOSemanticLSJDatasetMapper", "MaskFormerSemanticDatasetMapper"),
           "mask_former_panoptic": ("MaskFormerPanopticDatasetMapper",) * 2,
           "mask_former_instance": ("MaskFormerInstanceDatasetMapper",) * 2,
           "coco_instance_lsj": ("COCOInstanceLSJDatasetMapper",) * 2,
           "coco_panoptic_lsj": ("COCOInstanceLSJDatasetMapper",) * 2}


@pytest.mark.parametrize("name", sorted(MAPPERS))
def test_build_mapper_returns_the_mapper_jax_returns(jd, name):
    """The type and every attribute of Trainer.build_mapper's mapper, train
    and test, against the JAX Trainer's for each mapper name (the JAX
    method runs on a stand-in holding the preset)."""
    from autofocusformermod_tpu.engine.train import Trainer as JaxTrainer

    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_torch.engine.train import Trainer

    cfg = PRESETS["aff_mini_coco_instance"]()
    cfg.INPUT.DATASET_MAPPER_NAME = name
    cfg.INPUT.CROP.SIZE = [64, 64]
    port = Trainer.__new__(Trainer)
    port.cfg = cfg
    ref = SimpleNamespace(cfg=cfg, process_index=0)
    for is_train, want_name in zip((True, False), MAPPERS[name]):
        got, want = Trainer.build_mapper(port, is_train), JaxTrainer.build_mapper(ref, is_train)
        assert type(got).__name__ == type(want).__name__ == want_name
        attrs = {k: v for k, v in vars(want).items() if k != "rng"}
        assert {k: v for k, v in vars(got).items() if k != "rng"}.keys() == attrs.keys()
        for k, v in attrs.items():
            g = getattr(got, k)
            assert (np.array_equal(g, v) if isinstance(v, np.ndarray) else g == v), (k, g, v)
        assert got.rng.bit_generator.state == want.rng.bit_generator.state


# ---------------------------------------------------------------- presets
PRESET_YAMLS = {
    "aff_mini_cityscapes_panoptic":
        "configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_mini_bs32_45k.yaml",
    "aff_mini_coco_instance":
        "configs/coco/instance-segmentation/aff/maskformer2_aff_mini_bs64_50ep.yaml"}


@pytest.mark.parametrize("name", sorted(PRESET_YAMLS))
def test_task_preset_matches_yaml(name):
    """The preset equals merge_from_file of the published config
    (over its bases and the defaults) on every field it carries."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    from autofocusformermod_torch.config import PRESETS, train_image_size

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, PRESET_YAMLS[name]))
    seen = []

    def walk(preset, node, path):
        for k, v in preset.items():
            if isinstance(v, dict):
                walk(v, node[k], path + (k,))
            elif path + (k,) != ("MODEL", "DEVICE"):   # "cuda" here, "tpu" there
                got = node[k]
                seq = (list, tuple)
                assert (list(got) if isinstance(got, seq) else got) == (
                    list(v) if isinstance(v, seq) else v), path + (k,)
                seen.append(".".join(path + (k,)))

    preset = PRESETS[name]()
    walk(preset, cfg, ())
    assert {"MODEL.AFF.ALPHA", "MODEL.AFF.SHEPARD_POWER", "MODEL.SEM_SEG_HEAD.NUM_CLASSES",
            "MODEL.MASK_FORMER.TEST.PANOPTIC_ON", "MODEL.MASK_FORMER.TEST.INSTANCE_ON",
            "MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD", "INPUT.DATASET_MAPPER_NAME",
            "INPUT.MIN_SIZE_TEST", "INPUT.MAX_SIZE_TEST", "TEST.DETECTIONS_PER_IMAGE",
            "DATASETS.TEST", "SOLVER.MAX_ITER"} <= set(seen)
    if name == "aff_mini_cityscapes_panoptic":
        assert (preset.MODEL.AFF.ALPHA, preset.MODEL.SEM_SEG_HEAD.NUM_CLASSES) == (8.0, 19)
        sizes = preset.INPUT.MIN_SIZE_TRAIN
        assert (sizes[0], sizes[-1], len(sizes)) == (512, 2048, 16)
        assert train_image_size(preset) == (512, 1024)
    else:
        assert preset.MODEL.AFF.SHEPARD_POWER_LEARNABLE is False
        assert train_image_size(preset) == (1024, 1024) and "INPUT.IMAGE_SIZE" in seen
