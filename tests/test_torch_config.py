"""The port's configuration system against the JAX package's: its yaml
reader against PyYAML with the JAX loader (``_CfgLoader`` +
``_decode_leaves``) on every file under ``configs/``, the merged tree of
every non-base yaml against JAX's ``get_cfg`` + ``add_maskformer2_config``
+ ``merge_from_file`` leaf by leaf (types included, tuple against list;
MODEL.DEVICE the one listed difference), ``merge_from_list`` against JAX's
on a table of overrides (both accept with the same result, or both
refuse), what lies outside the reader's subset, a read without PyYAML,
the builds of every non-base yaml (on the meta device: shapes only) where
JAX's registry builds them, and the presets against their yamls.  Exact
throughout; every case is cheap (the parameter counts, which need JAX
traces, are in ``test_torch_config_builds.py``).
"""

import glob
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from autofocusformermod_torch.config import PRESETS, CfgNode, published_cfg, yaml_reader
from autofocusformermod_torch.config.cfg_node import decode_leaves
from autofocusformermod_torch.models.registry import build_model

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(Path(p).relative_to(REPO))
               for p in glob.glob(str(REPO / "configs" / "**" / "*.yaml"), recursive=True))
# a base is a file other yamls name in _BASE_ and that no one runs alone
PUBLISHED = [p for p in YAMLS if not os.path.basename(p).lower().startswith("base")]
# the port's deliberate differences from the JAX package's default tree
DEVICE = {"MODEL.DEVICE": ("tpu", "cuda")}

A, S = "configs/ade20k/", "configs/ade20k/semantic-segmentation/"
PRESET_YAMLS = {
    "aff_mini": A + "maskformer2_aff_mini_bs32_80k.yaml",
    "aff_mini_15": A + "maskformer2_aff_mini_15_bs32_80k.yaml",
    "aff_small": A + "maskformer2_aff_small_bs32_80k.yaml",
    "maskfiner_mini": S + "maskfiner/maskfiner_mini_bs32_80k.yaml",
    "maskfiner_updown_mini": S + "maskfiner/maskfiner_updown_mini_bs32_80k.yaml",
    "maskfiner_updown_tiny_coco_panoptic":
        "configs/coco/panoptic-segmentation/maskfiner/maskfiner_updown_tiny_bs16_50ep.yaml",
    "maskfiner_oracle_teacher_bb": S + "maskfiner/maskfiner_oracle_teacher_bb_bs32_80k.yaml",
    "maskfiner_oracle_teacher": S + "maskfiner/maskfiner_oracle_teacher_bs32_80k.yaml",
    "mrml_mini": S + "mixres-metaloss/maskformer2_mrml_mini_bs32_80k.yaml",
    "mrmlnb_mini": S + "mixres-metaloss-nb/maskformer2_mrmlnb_mini_bs32_80k.yaml",
    "mrmean_mini": S + "mixres-activation/maskformer2_mrmean_mini_bs32_80k.yaml",
    "aff_mini_cityscapes_panoptic":
        "configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_mini_bs32_45k.yaml",
    "aff_mini_coco_instance":
        "configs/coco/instance-segmentation/aff/maskformer2_aff_mini_bs64_50ep.yaml",
    "r50": S + "maskformer2_R50_bs16_160k.yaml",
    "swin_tiny": S + "swin/maskformer2_swin_tiny_bs16_160k.yaml",
    "swin_base_384_res640": S + "swin/maskformer2_swin_base_384_bs16_160k_res640.yaml",
}
# where a preset deliberately differs from its yaml: the COCO-panoptic yaml
# leaves SEM_SEG_HEAD.NUM_CLASSES at the default 150, which evaluation reads
# for the class count; the preset carries the model's 133 there
PRESET_DIFFERENCES = {"maskfiner_updown_tiny_coco_panoptic": {
    "MODEL.SEM_SEG_HEAD.NUM_CLASSES": (133, 150)}}


def same(a, b) -> bool:
    """Equal leaf by leaf, types included (any two mappings compare as
    mappings: the packages' node classes differ)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def jax_cfg(path=None):
    from autofocusformermod_tpu.config import add_deeplab_config, add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    if path:
        cfg.merge_from_file(str(REPO / path))
    return cfg


def test_every_yaml_is_listed_once():
    assert len(YAMLS) == 112 and len(PUBLISHED) == 98
    assert "configs/maskfiner_ade20k_semantic.yaml" in PUBLISHED


# ------------------------------------------------------------------ the reader
@pytest.mark.parametrize("path", YAMLS)
def test_reader_equals_pyyaml(path):
    """The raw document and the decoded one (yacs' literal_eval of string
    leaves) equal PyYAML's with the JAX loader."""
    yaml = pytest.importorskip("yaml")
    from autofocusformermod_tpu.config.cfg_node import _CfgLoader, _decode_leaves

    with open(REPO / path) as f:
        want = yaml.load(f, Loader=_CfgLoader)
    got = yaml_reader.load_file(str(REPO / path))
    assert same(got, want)
    assert same(decode_leaves(got or {}), _decode_leaves(want or {}))


SCALARS = ["1e-4", "1.0e-4", ".5", "-.inf", "0x1F", "010", "1_000", "+7", "yes", "Off", "FALSE",
           "~", "null", "", "x # c", "x#c", "'it''s'", '"a\\tb\\u00e9"', "(512, 512)",
           "[1, [2, 3], b c, 'd', \"e\",]", "[ ]", "1:30", "1.5:30.0"]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_scalars_equal_pyyaml(text):
    yaml = pytest.importorskip("yaml")
    src = f"A: {text}\n"
    assert same(yaml_reader.load(src), yaml.safe_load(src))


@pytest.mark.parametrize("text, line", [
    ("A:\n  - 1\n", 2),                           # a block sequence
    ("A: 1\nB: &x 2\n", 2),                       # an anchor
    ("A: 1\nB: *x\n", 2),                         # an alias
    ("A: !!str 1\n", 1),                          # another tag
    ("A: 1\n---\nB: 2\n", 2),                     # several documents
    ("A: {b: 1}\n", 1),                           # a flow mapping
    ("A: |\n  x\n", 1),                           # a block scalar
    ("A:\n  B: x\n    y\n", 3),                   # a plain scalar over two lines
    ("A: [1,\n  2]\n", 1),                        # a flow sequence over two lines
    ("A:\n\tB: 1\n", 2),                          # a tab in the indentation
    ('A: "x\n', 1),                               # an open quote
    ("A: b: c\n", 1),                             # a mapping on one line
    ("A: [b: c]\n", 1),                           # a mapping in a flow sequence
    ("A: 1\n  B: 2\n", 2),                        # indentation after a value
    ("A: 2002-12-14\n", 1),                       # a timestamp
    ('A: !!python/object/apply:eval ["__import__(\'os\')"]\n', 1),   # no builtins
    ('A: !!python/object/apply:eval ["1", "2"]\n', 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(yaml_reader.YamlSubsetError, match=rf"^cfg\.yaml:{line}: "):
        yaml_reader.load(text, "cfg.yaml")


def test_the_eval_tag_evaluates_with_range_int_and_float():
    got = yaml_reader.load('A: !!python/object/apply:eval ["[int(x * 0.1 * 512) for x in '
                           'range(5, 21)] + [float(2)]"]\n')
    assert got == {"A": [int(x * 0.1 * 512) for x in range(5, 21)] + [2.0]}


def test_reads_a_config_without_pyyaml():
    """A Cityscapes yaml (its bases and the eval tag) read by the package in
    a process where ``import yaml`` fails, as on the machine with the card."""
    path = "configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_base_384_bs16_90k.yaml"
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from autofocusformermod_torch.config import published_cfg\n"
            f"cfg = published_cfg({path!r})\n"
            "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
            "print(cfg.MODEL.AFF.NBHD_SIZE, cfg.INPUT.MIN_SIZE_TRAIN[-1], cfg.DATASETS.TEST)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[144, 144, 144, 144] 2048 ('cityscapes_fine_panoptic_val',)"


# ------------------------------------------------------------------ the tree
def test_default_tree_equals_jax_but_the_device():
    port, ref = published_cfg(), jax_cfg()
    for key, (jax_value, port_value) in DEVICE.items():
        node, leaf = key.rsplit(".", 1)
        assert ref.MODEL[leaf] == jax_value and port.MODEL[leaf] == port_value
        port.MODEL[leaf] = jax_value
    assert same(port, ref)


@pytest.mark.parametrize("path", PUBLISHED)
def test_merged_yaml_equals_jax(path):
    """get_cfg + add_deeplab_config + add_maskformer2_config +
    merge_from_file, leaf by leaf; and ``dump`` reads back to the same
    tree."""
    pytest.importorskip("yaml")
    port = published_cfg(str(REPO / path))
    assert port.MODEL.DEVICE == "cuda"
    port.MODEL.DEVICE = "tpu"
    assert same(port, jax_cfg(path))
    assert same(CfgNode(decode_leaves(yaml_reader.load(port.dump()))), port)


OVERRIDES = [
    ("SOLVER.MAX_ITER", "7"), ("SOLVER.BASE_LR", "1"), ("SOLVER.BASE_LR", "2e-4"),
    ("MODEL.MASK_ON", "1"), ("SOLVER.MAX_ITER", "True"), ("SOLVER.BETAS", "[0.8, 0.9]"),
    ("MODEL.AFF.DEPTHS", "(1, 1, 1, 1)"), ("SOLVER.WEIGHT_DECAY_BIAS", "0.5"),
    ("MODEL.SWIN.QK_SCALE", "'x'"), ("OUTPUT_DIR", "runs/x"), ("DATASETS.TRAIN", "('a',)"),
    ("INPUT.CROP.SIZE", "(64, 64)"), ("SOLVER.AMP.ENABLED", "False"),
    ("MODEL.SEM_SEG_HEAD.NUM_CLASSES", "19"), ("TEST.AUG.MIN_SIZES", "[512, 768]"),
    # refused by both
    ("SOLVER.MAX_ITER", "many"), ("SOLVER.BASE_LR", "'x'"), ("SOLVER.NOPE", "1"),
    ("MODEL.AFF", "1"), ("OUTPUT_DIR", "5"), ("SOLVER.MAX_ITER", "1.5"), ("MODEL.NOPE.X", "1"),
    ("SEED.X", "1"), ("MODEL.MASK_ON", "'yes'"), ("INPUT.CROP.SIZE", "64"),
]


@pytest.mark.parametrize("key, value", OVERRIDES)
def test_merge_from_list_agrees_with_jax(key, value):
    """Both accept an override with the same value and type, or both refuse
    it (the port with KeyError or TypeError where JAX raises
    AssertionError, TypeError or ValueError)."""
    path = PRESET_YAMLS["aff_mini"]
    port, ref = published_cfg(str(REPO / path)), jax_cfg(path)
    try:
        ref.merge_from_list([key, value])
        want = None
    except (AssertionError, TypeError, ValueError) as e:
        want = e
    if want is not None:
        with pytest.raises((KeyError, TypeError)):
            port.merge_from_list([key, value])
        return
    port.merge_from_list([key, value])
    node_p, node_r = port, ref
    for part in key.split("."):
        node_p, node_r = node_p[part], node_r[part]
    assert same(node_p, node_r)


def test_odd_overrides_and_frozen_trees_are_refused():
    cfg = published_cfg()
    with pytest.raises(ValueError, match="pairs"):
        cfg.merge_from_list(["SOLVER.MAX_ITER"])
    cfg.freeze()
    assert cfg.is_frozen() and cfg.SOLVER.is_frozen()
    for write in (lambda: setattr(cfg.SOLVER, "MAX_ITER", 3),
                  lambda: cfg.merge_from_list(["SOLVER.MAX_ITER", "3"]),
                  lambda: cfg.merge_from_other_cfg(CfgNode({"SEED": 3}))):
        with pytest.raises(AttributeError, match="frozen"):
            write()
    thawed = cfg.clone()
    assert not thawed.is_frozen() and not thawed.SOLVER.is_frozen()
    thawed.merge_from_other_cfg(CfgNode({"SOLVER": {"MAX_ITER": 3}, "NEW": {"KEY": 1}}))
    assert thawed.SOLVER.MAX_ITER == 3 and thawed.NEW.KEY == 1 and cfg.SOLVER.MAX_ITER == 40000
    cfg.defrost()
    cfg.SOLVER.MAX_ITER = 5
    assert cfg.SOLVER.MAX_ITER == 5


# ------------------------------------------------------------------ the builds
@pytest.mark.parametrize("path", PUBLISHED)
def test_published_yaml_builds_where_jax_builds(path):
    """JAX's registry builds the module of every published yaml; the port
    builds it too (on the meta device: parameters without storage)."""
    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    ref = jax_cfg(path)
    META_ARCH_REGISTRY.get(ref.MODEL.META_ARCHITECTURE)(ref)
    with torch.device("meta"):
        model = build_model(published_cfg(str(REPO / path)))
    assert sum(p.numel() for p in model.parameters()) > 1_000_000


@pytest.mark.parametrize("key, value", [
    ("MODEL.META_ARCHITECTURE", "'MaskFinerNope'"),
    ("MODEL.BACKBONE.NAME", "'ConvNeXtNope'"),
])
def test_a_config_jax_refuses_is_refused(key, value):
    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    path = PRESET_YAMLS["aff_mini"]
    ref, port = jax_cfg(path), published_cfg(str(REPO / path), [key, value])
    ref.merge_from_list([key, value])
    with pytest.raises(Exception):
        META_ARCH_REGISTRY.get(ref.MODEL.META_ARCHITECTURE)(ref)
    with pytest.raises((KeyError, NotImplementedError, ValueError)):
        with torch.device("meta"):
            build_model(port)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_agrees_with_its_yaml(name):
    """Every field a preset carries equals its merged yaml's (a list where
    the yaml gives a tuple), but the listed differences."""
    assert sorted(PRESET_YAMLS) == sorted(PRESETS)
    differ = PRESET_DIFFERENCES.get(name, {})
    merged = published_cfg(str(REPO / PRESET_YAMLS[name]))
    seen, found = [], {}

    def walk(preset, node, path):
        for k, v in preset.items():
            if isinstance(v, dict):
                walk(v, node[k], path + (k,))
                continue
            key, got = ".".join(path + (k,)), node[k]
            if key in differ:
                found[key] = (v, got)
            else:
                assert same(v, got), (key, v, got)
            seen.append(key)

    walk(PRESETS[name](), merged, ())
    assert found == differ
    assert {"MODEL.WEIGHTS", "SOLVER.BASE_LR", "SOLVER.MAX_ITER", "INPUT.DATASET_MAPPER_NAME",
            "DATASETS.TRAIN"} <= set(seen)
