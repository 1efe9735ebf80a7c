"""The PyTorch port's trainer: the default training step of an
AFF-Small-shaped tiny model against the JAX package, DropPath and LayerScale,
the AFF-Small preset, checkpoints, the Trainer's loop with resume and the NaN
watchdog, and the CLI.

Everything runs fp32 on the CPU.  The JAX comparison follows
``test_torch_train.py`` (same helpers, same tolerances: loss terms rtol 1e-4,
gradients rtol 1e-3 with atol 1e-4 of the parameter's largest gradient plus
1e-5, the update 1e-6), with both criteria left at their default, the
nearest-tap ranking, and a model shaped as AFF-Small is: 3 heads, MLP ratio
3, layer scale.  The trainer's own tests need no JAX: a resumed run must
reproduce the uninterrupted run exactly (same parameters, optimizer state
and loss terms, bit for bit), because the checkpoint restores every state
and the CPU sums in a fixed order.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch import train_net
from autofocusformermod_torch.config import aff_mini_cfg, aff_small_cfg
from autofocusformermod_torch.data.synthetic import synthetic_batch, synthetic_batches
from autofocusformermod_torch.engine.checkpoint import Checkpointer
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.engine.hooks import MetricLogger, device_memory_stats, nan_check
from autofocusformermod_torch.engine.train import Trainer
from autofocusformermod_torch.losses import criterion as tcrit
from autofocusformermod_torch.models.aff import AFF
from autofocusformermod_torch.models.layers import DropPath, set_dropout_generator
from autofocusformermod_torch.models.maskformer import maskformer_from_config

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_train import (check_gradients, check_loss_terms, check_update,
                              jax_reference_step, port_step, train_cfg)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------- the default step, AFF-Small-shaped, vs JAX
def small_shaped_cfg():
    cfg = train_cfg()
    a = cfg.MODEL.AFF
    a.EMBED_DIM, a.NUM_HEADS, a.MLP_RATIO = [12, 18, 24, 30], [3, 3, 3, 3], 3.0
    a.LAYER_SCALE, a.DROP_PATH_RATE = 0.5, 0.0
    return cfg


@pytest.fixture(scope="module")
def ref():
    from autofocusformermod_tpu.losses import criterion as jc

    assert jc.NN_RANK_UNCERTAINTY and tcrit.NN_RANK_UNCERTAINTY     # both defaults
    return jax_reference_step(small_shaped_cfg(), nn_rank=True)


@pytest.fixture(scope="module")
def port(ref):
    return port_step(ref)


def test_default_step_loss_terms_match_jax(ref, port):
    check_loss_terms(ref, port)


def test_default_step_every_gradient_matches_jax(ref, port):
    check_gradients(ref, port)
    for name in ("backbone.layers.0.blocks.0.gamma1", "backbone.layers.3.blocks.0.gamma2"):
        assert port["grads"][name].abs().max() > 0


def test_default_step_update_matches_optax(ref, port):
    check_update(ref, port)


def test_layer_scale_is_carried_across_and_back(ref):
    """gamma1/gamma2 go port -> JAX (convert_reference_state_dict, which the
    reference step used) -> port unchanged, under the backbone's default
    parameter group."""
    from autofocusformermod_torch.engine.optimizer import param_groups

    _, params, stats = ref["jax"]
    back = flax_to_torch_state_dict(params, stats)
    gammas = [k for k in ref["sd"] if k.endswith(("gamma1", "gamma2"))]
    assert len(gammas) == 2 * sum(ref["cfg"].MODEL.AFF.DEPTHS)
    for k in gammas:
        np.testing.assert_array_equal(back[k].numpy(), ref["sd"][k])
        assert (ref["sd"][k] == 0.5).all()
    groups = param_groups(maskformer_from_config(ref["cfg"]))
    assert set(gammas) <= {n for n, _ in groups["backbone_default"]}


def test_small_shaped_forward_matches_jax_in_eval_mode(ref):
    """3 heads, MLP ratio 3 and layer scale, eval mode: outputs within rtol =
    atol = 1e-4 (fp32 order over ~20 layers) and equal kept tokens."""
    import jax
    import jax.numpy as jnp

    jmodel, params, stats = ref["jax"]
    x = ref["batch"]["image"][:1]
    want, state = jax.jit(lambda v, im: jmodel.apply(
        v, im, train=False,
        capture_intermediates=lambda mdl, method: mdl.name == "backbone" and method == "__call__"
    ))({"params": params, "batch_stats": stats}, jnp.asarray(x.astype(np.float32)))
    feats = state["intermediates"]["backbone"]["__call__"][0]
    model = maskformer_from_config(ref["cfg"]).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref["sd"].items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        tfeats = model.backbone(model.normalize(torch.from_numpy(x)))
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    for stage in (2, 3, 4, 5):
        pos = tfeats[f"res{stage}_pos"].numpy()
        np.testing.assert_array_equal(
            pos, np.broadcast_to(np.asarray(feats[f"res{stage}_pos"]), pos.shape))


# ------------------------------------------------------- DropPath, LayerScale
def test_drop_path_matches_flax_on_replayed_keep_mask():
    """The flax module's keep decisions, read off its output, replayed into
    the port's DropPath: identical outputs (x / keep where kept, 0 elsewhere);
    eval mode and rate 0 are the identity."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.layers import DropPath as FlaxDropPath

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 5, 7)) + 3).astype(np.float32)
    want = np.asarray(FlaxDropPath(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                              rngs={"dropout": jax.random.PRNGKey(2)}))
    kept = np.abs(want).reshape(16, -1).max(1) > 0
    assert 0 < kept.sum() < 16
    dp = DropPath(0.3).train()
    dp.keep_mask = lambda shape, device: torch.from_numpy(kept).reshape(shape)
    np.testing.assert_array_equal(dp(torch.from_numpy(x)).numpy(), want)
    assert torch.equal(DropPath(0.3).eval()(torch.from_numpy(x)), torch.from_numpy(x))
    assert torch.equal(DropPath(0.0).train()(torch.from_numpy(x)), torch.from_numpy(x))


def test_drop_path_draws_from_its_generator():
    """Per-sample decisions from the explicit generator: reproducible from a
    seed, continued from a restored state, about ``1 - rate`` kept."""
    x = torch.ones(4000, 2, 3)
    dp = DropPath(0.25).train()
    dp.generator = torch.Generator().manual_seed(7)
    a = dp(x)
    state = dp.generator.get_state()
    b = dp(x)
    rows = a.reshape(4000, -1)
    assert ((rows == 0).all(1) | (rows == 1 / 0.75).all(1)).all()
    assert abs((rows[:, 0] > 0).float().mean().item() - 0.75) < 0.03
    dp.generator = torch.Generator().manual_seed(7)
    assert torch.equal(dp(x), a)
    dp.generator.set_state(state)
    assert torch.equal(dp(x), b) and not torch.equal(a, b)


def test_drop_path_rates_rise_linearly_over_the_depth():
    depths = (3, 4, 18, 2)
    aff = AFF(embed_dim=(6, 6, 6, 6), depths=depths, num_heads=(3, 3, 3, 3), mlp_ratio=3.0,
              drop_path_rate=0.3, layer_scale=1e-5)
    rates = [blk.drop_path.rate for layer in aff.layers for blk in layer.blocks]
    assert rates == [float(r) for r in np.linspace(0, 0.3, sum(depths))]
    gen = torch.Generator().manual_seed(0)
    set_dropout_generator(aff, gen)
    assert all(blk.drop_path.generator is gen for layer in aff.layers for blk in layer.blocks)
    blk = aff.layers[2].blocks[5]
    assert torch.equal(blk.gamma1.detach(), torch.full((6,), 1e-5))
    assert blk.mlp.fc1.out_features == 18
    plain = AFF(embed_dim=(6, 6, 6, 6), depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3))
    assert plain.layers[0].blocks[0].gamma1 is None
    assert not [n for n, _ in plain.named_parameters() if "gamma" in n]


# ------------------------------------------------------------------ the presets
def test_aff_small_preset_matches_yaml():
    """The preset equals merge_from_file of the published config on
    every field it carries, the trainer's included."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / "configs/ade20k/maskformer2_aff_small_bs32_80k.yaml"))
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

    preset = aff_small_cfg()
    walk(preset, cfg, ())
    assert {"SOLVER.IMS_PER_BATCH", "SOLVER.MAX_ITER", "SOLVER.CHECKPOINT_PERIOD", "SEED",
            "OUTPUT_DIR", "INPUT.CROP.SIZE", "MODEL.AFF.LAYER_SCALE", "MODEL.AFF.DROP_PATH_RATE",
            "MODEL.WEIGHTS"} <= set(seen)
    assert {"DATASETS.TRAIN", "DATASETS.TEST", "INPUT.MIN_SIZE_TRAIN", "INPUT.MAX_SIZE_TEST",
            "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "INPUT.COLOR_AUG_SSD", "INPUT.SIZE_DIVISIBILITY",
            "INPUT.DATASET_MAPPER_NAME", "TEST.EVAL_PERIOD", "TEST.EXPECTED_RESULTS",
            "TEST.AUG.MIN_SIZES", "TEST.SW_CROP_SIZE", "TEST.SAVE_EVAL_ARTIFACTS",
            "DATALOADER.NUM_WORKERS", "MODEL.SEM_SEG_HEAD.IGNORE_VALUE"} <= set(seen)
    a = preset.MODEL.AFF
    assert (a.EMBED_DIM, a.DEPTHS, a.NUM_HEADS) == ([96, 192, 384, 768], [3, 4, 18, 2],
                                                   [3, 6, 12, 24])
    assert (a.MLP_RATIO, a.DROP_PATH_RATE, a.LAYER_SCALE) == (3.0, 0.3, 1e-5)
    assert aff_mini_cfg().MODEL.AFF.LAYER_SCALE == 0.0          # the presets share no state


def test_cfg_overrides():
    cfg = aff_small_cfg()
    cfg.merge_from_list(["SOLVER.MAX_ITER", "7", "OUTPUT_DIR", "runs/x", "MODEL.AFF.DEPTHS",
                         "[1, 1, 1, 1]", "SOLVER.BASE_LR", "1", "INPUT.CROP.SIZE", "(64, 64)"])
    assert cfg.SOLVER.MAX_ITER == 7 and cfg.OUTPUT_DIR == "runs/x"
    assert cfg.MODEL.AFF.DEPTHS == [1, 1, 1, 1] and cfg.INPUT.CROP.SIZE == (64, 64)
    assert cfg.SOLVER.BASE_LR == 1.0 and isinstance(cfg.SOLVER.BASE_LR, float)
    with pytest.raises(KeyError, match="SOLVER.NOPE"):
        cfg.merge_from_list(["SOLVER.NOPE", "1"])
    with pytest.raises(KeyError, match="MODEL.AFF"):
        cfg.merge_from_list(["MODEL.AFF", "1"])
    with pytest.raises(TypeError, match="SOLVER.MAX_ITER"):
        cfg.merge_from_list(["SOLVER.MAX_ITER", "many"])
    with pytest.raises(ValueError, match="pairs"):
        cfg.merge_from_list(["SOLVER.MAX_ITER"])


# ------------------------------------------------------------- the tiny trainer
TINY = ["MODEL.AFF.EMBED_DIM", "[12, 18, 24, 30]", "MODEL.AFF.DEPTHS", "[1, 2, 1, 1]",
        "MODEL.AFF.NUM_HEADS", "[3, 3, 3, 3]", "MODEL.AFF.NBHD_SIZE", "[16, 16, 16, 16]",
        "MODEL.SEM_SEG_HEAD.CONVS_DIM", "16", "MODEL.SEM_SEG_HEAD.MASK_DIM", "16",
        "MODEL.MASK_FORMER.HIDDEN_DIM", "16", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "32",
        "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1", "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "6",
        "MODEL.MASK_FORMER.DEC_LAYERS", "3", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "6",
        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "TPU.MAX_GT_INSTANCES", "6",
        "INPUT.CROP.SIZE", "[128, 128]", "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.BASE_LR", "0.001"]


def tiny_trainer_cfg(output_dir, *extra):
    """AFF-Small's preset (DropPath 0.3, layer scale) cut to a tiny size."""
    cfg = aff_small_cfg()
    cfg.merge_from_list(TINY + ["OUTPUT_DIR", str(output_dir)] + list(extra))
    return cfg


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Importing TensorBoard costs ~15 s here; the logger goes without it
    where it cannot be imported."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _run(cfg, max_iter, resume=False):
    trainer = Trainer(cfg, torch.device("cpu"))
    trainer.resume_or_load(resume=resume)
    trainer.train(synthetic_batches(cfg, trainer.device, trainer.start_step), max_iter=max_iter)
    return trainer


def _metrics(cfg):
    import json

    lines = (Path(cfg.OUTPUT_DIR) / "metrics.jsonl").read_text().splitlines()
    return {m["step"]: m for m in map(json.loads, lines)}


def test_trainer_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Four steps in one go against three steps, a new process's worth of
    Trainer that resumes, and the fourth: the fourth step's loss terms, every
    parameter, BatchNorm statistic and optimizer state are equal bit for bit,
    with DropPath live (so its generator's state was restored too)."""
    cfg_a = tiny_trainer_cfg(tmp_path / "a")
    cfg_b = tiny_trainer_cfg(tmp_path / "b")
    whole = _run(cfg_a, 4)
    first = _run(cfg_b, 3)
    assert first.checkpointer.latest_step() == 3
    del first                                        # the run is killed here
    resumed = Trainer(cfg_b, torch.device("cpu"))
    assert resumed.start_step == 0
    resumed.resume_or_load(resume=True)
    assert resumed.start_step == 3
    resumed.train(synthetic_batches(cfg_b, resumed.device, resumed.start_step), max_iter=4)

    ma, mb = _metrics(cfg_a), _metrics(cfg_b)
    assert sorted(ma) == sorted(mb) == [1, 2, 3, 4]
    terms = [k for k in ma[4] if k.startswith(("loss_", "total_", "grad_"))]
    assert len(terms) == 3 * 3 + 2
    for step in (1, 2, 3, 4):
        assert {k: ma[step][k] for k in terms} == {k: mb[step][k] for k in terms}, step
    assert ma[1]["total_loss"] != ma[4]["total_loss"]
    sa, sb = whole.model.state_dict(), resumed.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = whole.step_fn.optimizer.state_dict(), resumed.step_fn.optimizer.state_dict()
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert [g["lr"] for g in oa["param_groups"]] == [g["lr"] for g in ob["param_groups"]]
    for k, g in whole.generators.items():
        assert torch.equal(g.get_state(), resumed.generators[k].get_state()), k
    # DropPath was live, and a run that does not resume differs
    rates = [m.rate for m in whole.model.modules() if isinstance(m, DropPath)]
    assert max(rates) == pytest.approx(0.3)
    fresh = _run(tiny_trainer_cfg(tmp_path / "c", "SEED", "1"), 1)
    assert _metrics(fresh.cfg)[1]["total_loss"] != ma[1]["total_loss"]


def test_trainer_checkpoints_on_period_and_at_the_end(tmp_path):
    cfg = tiny_trainer_cfg(tmp_path, "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.MAX_ITER", "3")
    trainer = _run(cfg, None)
    assert trainer.checkpointer.steps() == [2, 3]
    state = trainer.checkpointer.restore(2)
    assert state["step"] == 2
    assert set(state) == {"step", "model", "optimizer", "scheduler", "generators"}
    assert set(state["generators"]) == {"criterion", "dropout"}
    assert "backbone.patch_embed.bn.running_mean" in state["model"]
    # the schedule ran to SOLVER.MAX_ITER = 3: lr (1 - 2/3) ** 0.9 of its base after 2 steps
    lrs = {g["label"]: g["lr"] for g in state["optimizer"]["param_groups"]}
    assert lrs["default"] == pytest.approx(1e-3 * (1 / 3) ** 0.9)
    assert lrs["backbone_default"] == pytest.approx(1e-4 * (1 / 3) ** 0.9)


def test_trainer_nan_watchdog_raises(tmp_path, capsys):
    cfg = tiny_trainer_cfg(tmp_path)
    trainer = Trainer(cfg, torch.device("cpu"))
    # a NaN in the mask branch (the matcher maps NaN mask costs to a large
    # cost, as the JAX package's does, so the step runs to its loss)
    with torch.no_grad():
        trainer.model.sem_seg_head.predictor.mask_embed.layers[-1].bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        trainer.train(synthetic_batches(cfg, trainer.device))
    # the update has run by then, so the NaN gradients are in every parameter
    assert "[nan_check] non-finite values in ['backbone.patch_embed" in capsys.readouterr().out
    assert trainer.checkpointer.latest_step() is None


def test_trainer_loads_weights_and_leaves_data_to_a_later_slice(tmp_path, capsys):
    cfg = tiny_trainer_cfg(tmp_path, "SEED", "3")
    donor = Trainer(cfg, torch.device("cpu"))
    path = tmp_path / "weights.pth"
    torch.save(donor.model.state_dict(), path)
    cfg2 = tiny_trainer_cfg(tmp_path, "SEED", "4", "MODEL.WEIGHTS", str(path))
    trainer = Trainer(cfg2, torch.device("cpu"))
    name = "sem_seg_head.predictor.class_embed.weight"
    assert not torch.equal(trainer.model.state_dict()[name], donor.model.state_dict()[name])
    trainer.resume_or_load(resume=True)                # no checkpoint: falls to the weights
    assert torch.equal(trainer.model.state_dict()[name], donor.model.state_dict()[name])
    assert trainer.start_step == 0
    Trainer(cfg, torch.device("cpu")).resume_or_load()
    assert "aff_small.pth not found; training from scratch" in capsys.readouterr().out
    # the data path: the loader builds from a registered directory (the
    # mapper's crop padded to 128); what is not ported yet names ROADMAP.md
    cfg3 = tiny_trainer_cfg(tmp_path / "c", *tiny_dataset(tmp_path / "data", "loads"))
    trainer = Trainer(cfg3, torch.device("cpu"))
    loader = trainer.build_train_loader()
    try:
        batch = next(loader)
    finally:
        loader.close()
    assert batch["image"].shape == (2, 128, 128, 3) and batch["labels"].shape == (2, 6)
    for sem, labels, valid in zip(batch["sem_seg_map"], batch["labels"], batch["valid"]):
        present = np.unique(sem)
        assert list(labels[valid]) == list(present[present != 255][:6])
    from autofocusformermod_torch.data.mapper_panoptic_instance import (
        MaskFormerPanopticDatasetMapper)

    cfg3.INPUT.DATASET_MAPPER_NAME = "mask_former_panoptic"
    assert isinstance(trainer.build_mapper(is_train=True), MaskFormerPanopticDatasetMapper)
    cfg3.INPUT.DATASET_MAPPER_NAME = "mask_former_semantic"
    cfg3.DATASETS.TRAIN = ["ade20k_sem_seg_train"]              # no files under datasets/
    with pytest.raises(FileNotFoundError, match="hold no sample"):
        trainer.build_train_loader()
    from autofocusformermod_torch.data.catalog import MetadataCatalog

    MetadataCatalog.get(cfg3.DATASETS.TEST[0]).set(evaluator_type="coco_panoptic_seg")
    calls = []
    real = Trainer._eval_panoptic
    Trainer._eval_panoptic = lambda self, name: calls.append(name) or {"PQ": 0.0}
    try:
        assert trainer.test() == {cfg3.DATASETS.TEST[0]: {"PQ": 0.0}}
        assert calls == [cfg3.DATASETS.TEST[0]]
    finally:
        Trainer._eval_panoptic = real
        MetadataCatalog.get(cfg3.DATASETS.TEST[0]).set(evaluator_type="sem_seg")


def test_trainer_merges_a_wrapped_backbone_only_reference_file(tmp_path, capsys):
    """MODEL.WEIGHTS as the yamls name it: a backbone-only pretrain file, here
    wrapped in {"model": ...} with DataParallel's "module." prefix.  The
    backbone's entries load, the rest keep their initial values, and the
    count is printed."""
    donor = Trainer(tiny_trainer_cfg(tmp_path, "SEED", "3"), torch.device("cpu"))
    backbone = {k: v for k, v in donor.model.state_dict().items() if k.startswith("backbone.")}
    path = tmp_path / "aff_small.pth"
    torch.save({"model": {"module." + k: v for k, v in backbone.items()}}, path)
    trainer = Trainer(tiny_trainer_cfg(tmp_path, "SEED", "4", "MODEL.WEIGHTS", str(path)),
                      torch.device("cpu"))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.resume_or_load(resume=True)
    after = trainer.model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, backbone[k] if k in backbone else before[k]), k
    name = "backbone.layers.0.blocks.0.attn.blank_k"
    assert name in backbone and not torch.equal(after[name], before[name])   # seeds differ
    assert f"[convert_checkpoint] loaded {len(backbone)}/{len(after)} tensors; missing e.g. " \
        in capsys.readouterr().out
    assert trainer.start_step == 0


# ------------------------------------------------------------- the checkpointer
def test_checkpoint_round_trip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    gen = torch.Generator().manual_seed(5)
    for step in (1, 2, 3):
        ck.save(step, {"step": step, "model": {"w": torch.full((3,), float(step))},
                       "optimizer": {"param_groups": [{"lr": 0.1, "betas": (0.9, 0.999),
                                                       "label": "default", "fused": None}]},
                       "generators": {"criterion": gen.get_state()}})
    ck.wait()
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert not [f for f in (tmp_path / "ck").iterdir() if f.name.endswith(".tmp")]
    state = ck.restore()
    assert state["step"] == 3 and torch.equal(state["model"]["w"], torch.full((3,), 3.0))
    assert state["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)
    want = torch.rand(4, generator=gen)
    other = torch.Generator()
    other.set_state(state["generators"]["criterion"])
    assert torch.equal(torch.rand(4, generator=other), want)
    assert ck.restore(2)["step"] == 2
    # a torn temporary file of a killed run is not taken for a checkpoint
    (tmp_path / "ck" / "step_00000009.pt.123.tmp").write_bytes(b"torn")
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 3


# ------------------------------------------------------------------- the hooks
def test_hooks(tmp_path, capsys):
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(1, 2)).sum().backward()
    opt.step()
    assert nan_check(model, opt) == []
    opt.state[model.weight]["exp_avg"][0, 0] = float("inf")
    with torch.no_grad():
        model.bias[1] = float("nan")
    assert nan_check(model, opt) == ["bias", "optimizer.weight.exp_avg"]
    assert "non-finite" in capsys.readouterr().out
    assert device_memory_stats(torch.device("cpu")) == {}
    logger = MetricLogger(str(tmp_path), period=2)
    for step in (1, 2):
        logger.log(step, {"total_loss": torch.tensor(1.5), "loss_ce_3": 2.0, "loss_ce": 1})
    logger.close()
    out = capsys.readouterr().out
    assert "[step 2]" in out and "[step 1]" not in out and "loss_ce_3" not in out
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"loss_ce_3": 2.0' in lines[0] and '"step": 1' in lines[0]


# ------------------------------------------------------ synthetic data, the CLI
def test_synthetic_batches_depend_on_seed_and_step_alone():
    cfg = tiny_trainer_cfg("unused")
    a = [b for b, _ in zip(synthetic_batches(cfg, "cpu"), range(3))]
    later = next(synthetic_batches(cfg, "cpu", start_step=2))
    for k in a[2]:
        assert torch.equal(a[2][k], later[k]), k
    assert not torch.equal(a[0]["image"], a[1]["image"])
    b = a[0]
    assert b["image"].shape == (2, 128, 128, 3) and b["image"].dtype == torch.uint8
    assert b["sem_seg_map"].shape == (2, 128, 128) and b["labels"].shape == (2, 6)
    for i in range(2):
        present = torch.unique(b["sem_seg_map"][i]).long()
        assert torch.equal(b["labels"][i][b["valid"][i]], present) and len(present) == 6
    with pytest.raises(ValueError, match="multiple"):
        synthetic_batch(torch.Generator(), "cpu", 1, (100, 100), 6, 6)


def test_cli_trains_resumes_and_needs_a_device(tmp_path, monkeypatch):
    args = ["--config", "aff_small", "--synthetic", "--device", "cpu"] + TINY + [
        "OUTPUT_DIR", str(tmp_path)]
    trainer = train_net.main(args[:3] + ["--max-iter", "2"] + args[3:])
    assert trainer.start_step == 2 and trainer.checkpointer.steps() == [2]
    assert trainer.cfg.MODEL.AFF.LAYER_SCALE == 1e-5 and trainer.cfg.SOLVER.MAX_ITER == 80000
    trainer = train_net.main(args[:3] + ["--max-iter", "3", "--resume"] + args[3:])
    assert trainer.start_step == 3 and trainer.checkpointer.steps() == [2, 3]
    assert sorted(_metrics(trainer.cfg)) == [1, 2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_net.main(["--config", "aff_small", "--synthetic", "OUTPUT_DIR", str(tmp_path)])
    # without --synthetic the CLI trains from DATASETS.TRAIN and evaluates
    # DATASETS.TEST every TEST.EVAL_PERIOD steps; --eval-only evaluates alone
    data = tiny_dataset(tmp_path / "data", "cli") + ["TEST.EVAL_PERIOD", "2"]
    out = ["OUTPUT_DIR", str(tmp_path / "x")]
    trainer = train_net.main(["--config", "aff_mini", "--device", "cpu", "--max-iter", "2"] +
                             TINY + data + out)
    assert trainer.start_step == 2 and sorted(_metrics(trainer.cfg)) == [1, 2]
    in_loop = trainer.results
    assert set(in_loop) == {"cli_val"} and 0 <= in_loop["cli_val"]["mIoU"] <= 100
    evaluated = train_net.main(["--config", "aff_mini", "--device", "cpu", "--eval-only",
                                "--resume"] + TINY + data + out)
    assert evaluated.start_step == 2 and evaluated.results == in_loop
    assert sorted(_metrics(trainer.cfg)) == [1, 2]               # nothing trained


def tiny_dataset(root, name):
    """Register {name}_train and {name}_val: JPEG + PNG pairs written under
    root (4 train and 2 test images, 6 classes); the config overrides that
    read them at the tiny trainer's 128x128 crop."""
    from autofocusformermod_torch.data.catalog import DatasetCatalog
    from autofocusformermod_torch.data.datasets import register_sem_seg
    from test_torch_data import write_pairs

    for split, sizes in (("train", [(150, 200), (128, 170), (180, 128), (140, 140)]),
                         ("val", [(128, 192), (100, 180)])):
        imgs, gts = write_pairs(Path(root) / split, sizes, seed=len(split), classes=(0, 6))
        DatasetCatalog.remove(f"{name}_{split}")
        register_sem_seg(f"{name}_{split}", imgs, gts, [f"c{i}" for i in range(6)])
    return ["DATASETS.TRAIN", f"('{name}_train',)", "DATASETS.TEST", f"('{name}_val',)",
            "INPUT.MIN_SIZE_TRAIN", "[128, 160]", "INPUT.SIZE_DIVISIBILITY", "128",
            "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "256", "DATALOADER.NUM_WORKERS",
            "2"]


# ---------------------------------------------------------------- the port's imports
def test_port_sources_name_no_jax_import():
    """No file of the port (its config package, yaml reader, demo and
    analysis tool included), and none of chip_smoke.py, interleaved_ab.py
    and nearest_ab.py, imports jax, flax, optax, yaml or the JAX package
    (docstrings may name them)."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|yaml|orbax|autofocusformermod_tpu)\b",
                     re.M)
    files = list((REPO / "autofocusformermod_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "interleaved_ab.py", REPO / "nearest_ab.py"]
    assert len(files) > 30
    port = REPO / "autofocusformermod_torch"
    assert {port / "config" / name for name in ("__init__.py", "cfg_node.py", "yaml_reader.py",
                                                "defaults.py", "presets.py")} | {
        port / "demo.py", port / "tools" / "analyze_model.py"} <= set(files)
    bad = {str(f.relative_to(REPO)): pat.findall(f.read_text()) for f in files
           if pat.search(f.read_text())}
    assert not bad, bad
