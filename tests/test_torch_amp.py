"""The PyTorch port's bf16 mixed precision (SOLVER.AMP.ENABLED,
``autofocusformermod_torch/parallel/precision.py``) against the JAX
package's (``parallel/precision.py``), for every build function that honours it:
``maskformer_from_config`` (AFF and R50 backbones) and
``maskformer_ml_from_config`` here, ``maskfiner_from_config``,
``maskfiner_oracle_teacher_from_config`` and
``maskfiner_oracle_teacher_bb_from_config`` in
``test_torch_amp_cascades.py`` (the same tests; the island tests cover all
six here).

Each build function's tiny model of its own test module (its ``tiny_cfg``) is
built with AMP on, its weights seeded in the port as its fp32 tests seed
them (``port_model``) and carried to a JAX parameter tree made by ``jax.eval_shape``
(``torch_to_flax``; no JAX init).  The same uint8 images (batch 2) and label
maps go through both.  The checks:

- every parameterised module's output dtype in the port equals JAX's under
  ``amp_variables`` (bf16 compute; fp32 where KEEP_F32 or flax's dtype
  promotion makes it so), backbone features bf16 with fp32 positions, the
  model's outputs fp32, and every kernel wrapper's float operands fp32;
- stage-1 features and the first auxiliary class logits within
  ``tests/test_amp.py``'s budgets of JAX's bf16 run: max |diff| / std <
  0.10 and mean |diff| / std < 0.01 (the two runs round in different
  orders); the final logits correlated above 0.9 (past the first
  discrete choice bf16 rounding flips near-tied tokens, ROADMAP.md
  section 3);
- one AMP training step on replayed criterion draws (``grads_only``),
  its discrete choices replayed from the fp32 step (``chip_smoke.py:
  same_choices``): fp32 master parameters, gradients, AdamW moments and
  BatchNorm statistics, and every loss term within 10 % of JAX's AMP step
  (relative to the term, or 2e-3 absolute for a term near 0);
- for each AFF_F32_ISLANDS name, the parameters the bf16 view keeps fp32
  are exactly those JAX's keeps; the AFF MaskFormer runs each island
  with JAX's module dtypes, the other build functions refuse islands;
- MaskFormerSwin stays fp32 under AMP, as JAX's build function keeps it.

The MaskFinerOracleTeacher cascade's projection pixel decoders cast their
levels to fp32, as JAX's do, and every later layer those levels reach
computes in fp32 with the bf16 view of its weights (flax's promotion,
``autofocusformermod_torch/dtypes.py``): the dtype check holds every
module of it, mixed ones included.
"""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.engine.convert_checkpoint import torch_name
from autofocusformermod_torch.engine.train_step import TrainStep, criterion_config
from autofocusformermod_torch.models.maskfiner import maskfiner_from_config
from autofocusformermod_torch.models.maskformer import init_random_weights
from autofocusformermod_torch.models.registry import build_model
from autofocusformermod_torch.parallel import precision

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_maskfiner_train import jax_group_draws
from test_torch_mrml import fast_jit, grads_only
from test_torch_sampler import Replay
from test_torch_updown import label_maps, step_batch, torch_to_flax

B = 2
BUDGET_MAX, BUDGET_MEAN, MIN_CORR = 0.10, 0.01, 0.9
LOSS_RTOL, LOSS_ATOL = 0.10, 2e-3
ISLANDS = ("backbone", "pixel_decoder", "decoder", "mask_head")


def _aff():
    import test_torch_train

    return test_torch_train.train_cfg()


def _r50():
    import test_torch_resnet

    return test_torch_resnet.tiny_r50_cfg()


def _maskfiner():
    from test_maskfiner import tiny_maskfiner_cfg

    cfg = tiny_maskfiner_cfg()
    cfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    cfg.MODEL.MASK_FINER.TRAIN_NUM_POINTS = 64
    return cfg


def _ot():
    import test_torch_oracle_teacher

    return test_torch_oracle_teacher.tiny_cfg()


def _otbb():
    import test_torch_updown

    return test_torch_updown.tiny_cfg()


def _mrml():
    import test_torch_mrml

    return test_torch_mrml.tiny_cfg()


# build function: (its tiny config, image side, the port module whose output holds
# the first stage's features, the JAX module path of the same)
ARCHS = {
    "aff": (_aff, 128, "backbone", ("backbone",)),
    "r50": (_r50, 64, "backbone", ("backbone",)),
    "maskfiner": (_maskfiner, 64, "mask_predictors.0.backbone",
                  ("mask_predictors_0", "backbone")),
    "oracle_teacher": (_ot, 64, "mask_predictors.0.backbone", ("mask_predictors_0", "backbone")),
    "oracle_teacher_bb": (_otbb, 64, "backbone.backbones.0", ("backbone", "backbones_0")),
    "maskformer_ml": (_mrml, 128, "backbone.layers.0", ("backbone", "layers_0")),
}
# this file's build functions; test_torch_amp_cascades.py runs the same tests on the
# MaskFiner cascades (two files, so that two test workers share the JAX
# compiles)
MASKFORMERS = ("aff", "r50", "maskformer_ml")
CASCADES = ("maskfiner", "oracle_teacher", "oracle_teacher_bb")


def amp_cfg(arch):
    cfg = ARCHS[arch][0]()
    cfg.SOLVER.AMP.ENABLED = True
    return cfg


def port_model(cfg):
    """The port model of ``cfg`` (MaskFiner by its build function: the tiny config's
    META_ARCHITECTURE names it) with the seeded weights of its fp32 tests
    (``init_random_weights`` for the MaskFormers, as ``test_torch_train.py``
    and ``test_torch_mrml.py``; a torch seed for the cascades with the class
    heads perturbed by more, as ``test_torch_updown.seeded_port``)."""
    torch.manual_seed(0)
    if cfg.MODEL.META_ARCHITECTURE.startswith("MaskFormer"):
        return init_random_weights(build_model(cfg), torch.Generator().manual_seed(0))
    model = (maskfiner_from_config(cfg) if cfg.MODEL.META_ARCHITECTURE == "MaskFiner"
             else build_model(cfg))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name:
                p.add_(torch.randn(p.shape))
    return model


def jax_model(cfg):
    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jmaskfiner
    from test_torch_mrml import jax_model as registry_model

    return jmaskfiner(cfg) if cfg.MODEL.META_ARCHITECTURE == "MaskFiner" else registry_model(cfg)


def with_gt(cfg):
    return cfg.MODEL.META_ARCHITECTURE.startswith("MaskFinerOracle")


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _leaves(x):
    """The tensors / arrays of a nested output."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x] if hasattr(x, "dtype") else []


def _float_dtypes(x):
    return {str(t.dtype).replace("torch.", "") for t in _leaves(x)
            if (t.is_floating_point() if torch.is_tensor(t) else "float" in str(t.dtype))}


def jax_module_dtypes(intermediates):
    """{port module name: the float dtypes of its outputs} from JAX's
    captured intermediates, for the modules that hold parameters (named
    through the weights bridge)."""
    got = {}
    for path, v in _walk(intermediates):
        if path[-1] != "__call__" or len(path) < 2:
            continue
        name = torch_name(path[:-1] + ("bias",))[:-len(".bias")]
        got.setdefault(name, set()).update(_float_dtypes(v))
    return got


def port_forward(model, args, hook_names=()):
    """The port's AMP eval forward -> (outputs, {parameterised module name:
    the float dtypes of its outputs}, {hooked name: its output}, the float
    dtypes of every kernel wrapper's operands)."""
    dtypes, hooked, handles = {}, {}, []
    for name, m in model.named_modules():
        if name in hook_names:
            handles.append(m.register_forward_hook(
                lambda mod, i, o, name=name: hooked.__setitem__(name, o)))
        if next(m.parameters(recurse=False), None) is not None:
            handles.append(m.register_forward_hook(
                lambda mod, i, o, name=name: dtypes.setdefault(name, set()).update(
                    _float_dtypes(o))))
    with kernel_operands() as operands, torch.no_grad():
        out = precision.apply(model.eval(), *args)
    for h in handles:
        h.remove()
    return out, dtypes, hooked, set(operands)


class kernel_operands:
    """Within this block every kernel wrapper's dispatch (``use_kernel``)
    records the dtypes of its float operands."""

    def __enter__(self):
        import sys

        from autofocusformermod_torch.ops import dispatch

        self.seen, self.patched = [], []
        real = dispatch.use_kernel

        def spy(*tensors):
            self.seen.extend(str(t.dtype).replace("torch.", "") for t in tensors
                             if t.is_floating_point())
            return real(*tensors)

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "") or "").startswith("autofocusformermod_torch.") \
                    and getattr(mod, "use_kernel", None) is real:
                self.patched.append(mod)
                mod.use_kernel = spy
        self.real = real
        return self.seen

    def __exit__(self, *exc):
        for mod in self.patched:
            mod.use_kernel = self.real


def _scaled(a, b):
    """(max |a - b| / std(a), mean |a - b| / std(a)) in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.std(a) + 1e-6
    return np.max(np.abs(a - b)) / scale, np.mean(np.abs(a - b)) / scale


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def stage_features(o):
    """(features, positions or None) of a first stage's output: a stage's
    (outs, ...) or outs dict (its finest res* entry: a backbone's first
    stage, a cascade stage's one), a MixResLayer's (pos, x), or a tensor."""
    if isinstance(o, tuple) and isinstance(o[0], dict):
        o = o[0]
    if isinstance(o, dict):
        key = min(k for k in o if k[:3] == "res" and k[3:].isdigit())
        return o[key], o[key + "_pos"]
    return (o[-1] if isinstance(o, tuple) else o), None


@pytest.fixture(scope="module", params=MASKFORMERS)
def amp(request):
    return amp_reference(request.param)


def amp_reference(name):
    """One build function's JAX side, one compiled call (the AMP eval forward with
    every module's output, and one AMP step), and the port's AMP forward on
    the same weights and images."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.parallel.precision import amp_variables
    from autofocusformermod_tpu.parallel.train_step import (TrainState, make_maskfiner_train_step,
                                                             make_train_step)

    _, size, port_mod, jax_path = ARCHS[name]
    cfg = amp_cfg(name)
    cascade = cfg.MODEL.META_ARCHITECTURE.startswith("MaskFiner")
    model = port_model(cfg)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    jm = jax_model(cfg)
    mf, nc = criterion_config(cfg)
    if name == "aff":
        from test_torch_train import semantic_batch

        sb = semantic_batch(np.random.default_rng(0))
        x, gt = sb["image"], sb["sem_seg_map"]
    else:
        rng = np.random.default_rng(0)
        x = rng.integers(0, 256, (B, size, size, 3)).astype(np.uint8)
        gt = label_maps(rng, B, size, nc)
    gt_args = (jnp.asarray(gt.astype(np.int32)),) if with_gt(cfg) else ()
    xf = jnp.asarray(x.astype(np.float32))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "oracle": jax.random.PRNGKey(1)}, xf, *gt_args))
    variables = jax.tree.map(jnp.asarray, {k: torch_to_flax(v, sd) for k, v in shapes.items()})

    slots = min(4, (mf if cascade else cfg.MODEL.MASK_FORMER).NUM_OBJECT_QUERIES)
    batch = step_batch(x, gt, slots)
    common = dict(eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
                  mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
                  num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
                  importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO, donate=False, amp=True)
    if cascade:
        step = make_maskfiner_train_step(jm, nc, upsampling_weight=float(mf.UPSAMPLING_WEIGHT),
                                         needs_sem_seg_gt=with_gt(cfg), **common)
    else:
        ml = cfg.MODEL.META_ARCHITECTURE == "MaskFormerML"
        step = make_train_step(jm, nc, metaloss_weight=mf.METALOSS_WEIGHT if ml else 0.0,
                               ml_min_patch_size=min(cfg.MODEL.MRML.PATCH_SIZES) if ml else 4,
                               **common)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if k in ("sem_seg_map", "labels") else v)
              for k, v in batch.items()}
    jbatch["image"], jbatch["sem_seg"] = xf, jbatch["sem_seg_map"]
    state = TrainState.create(variables["params"], variables.get("batch_stats", {}),
                              grads_only())
    k_step = jax.random.PRNGKey(5)

    def both(v, state, batch, key):
        out, inter = jm.apply(amp_variables(v), xf, *gt_args, train=False,
                              capture_intermediates=True)
        return out, inter["intermediates"], step(state, batch, key)[1]

    out, inter, metrics = fast_jit(both, variables, state, jbatch, k_step)(
        variables, state, jbatch, k_step)
    node = inter
    for p in jax_path:
        node = node[p]
    k_crit = jax.random.split(k_step, 3 if cascade else 2)[-1]
    mask_shapes = [tuple(o["pred_masks"].shape[-2:]) for o in [out] + list(out["aux_outputs"])]

    targs = (torch.from_numpy(x),) + ((torch.from_numpy(gt),) if with_gt(cfg) else ())
    pout, pdtypes, hooked, operands = port_forward(model, targs, (port_mod,))
    return {"name": name, "cfg": cfg, "sd": sd, "batch": batch,
            "out": jax.tree.map(np.asarray, out), "jdtypes": jax_module_dtypes(inter),
            "stage1": stage_features(jax.tree.map(np.asarray, node["__call__"][0])),
            "draws": jax_group_draws(k_crit, mask_shapes, B, slots, mf.TRAIN_NUM_POINTS),
            "metrics": {k: float(v) for k, v in metrics.items()}, "pout": pout,
            "pdtypes": pdtypes, "pstage1": stage_features(hooked[port_mod]),
            "operands": operands}


# ------------------------------------------------------------------ dtypes
def test_amp_module_dtypes_match_jax(amp):
    """Every parameterised module that both run computes in JAX's dtype;
    the first stage's features are bf16 beside fp32 positions; the model's
    outputs are fp32; every kernel receives fp32 operands.  (On a port that
    ignores SOLVER.AMP.ENABLED every module computes fp32 and this fails.)"""
    jd, pd = amp["jdtypes"], amp["pdtypes"]
    common = set(jd) & set(pd)
    assert len(common) >= 8, sorted(common)
    assert {n: pd[n] for n in common if pd[n] != jd[n]} == {}
    assert any("bfloat16" in pd[n] for n in common)
    feat, pos = amp["pstage1"]
    assert feat.dtype == torch.bfloat16 and amp["stage1"][0].dtype.name == "bfloat16"
    assert pos is None or pos.dtype == torch.float32 and amp["stage1"][1].dtype == np.float32
    assert _float_dtypes(amp["pout"]) == {"float32"}
    assert _float_dtypes(amp["out"]) == {"float32"}
    assert amp["operands"] == {"float32"}


# ------------------------------------------------------------------ values
def test_amp_outputs_within_budget_of_jax(amp):
    """Stage-1 features and the first auxiliary class logits within
    test_amp.py's budgets of JAX's bf16 run; the final logits finite and
    correlated above 0.9: the class logits of the cascades (their class
    heads perturbed), the mask logits of the MaskFormers (whose randomly
    initialised class heads hardly vary between queries)."""
    mx, mean = _scaled(amp["stage1"][0], _np(amp["pstage1"][0]))
    assert mx < BUDGET_MAX and mean < BUDGET_MEAN, (mx, mean)
    mx, _ = _scaled(amp["out"]["aux_outputs"][0]["pred_logits"],
                    _np(amp["pout"]["aux_outputs"][0]["pred_logits"]))
    assert mx < BUDGET_MAX, mx
    final = ("pred_logits" if amp["cfg"].MODEL.META_ARCHITECTURE.startswith("MaskFiner")
             else "pred_masks")
    assert all(np.all(np.isfinite(_np(amp["pout"][k]))) for k in ("pred_logits", "pred_masks"))
    a = np.asarray(amp["out"][final], np.float64).ravel()
    b = _np(amp["pout"][final]).astype(np.float64).ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR


# ------------------------------------------------------------------ the step
def port_step_losses(cfg, sd, batch, draws):
    """The port's TrainStep on ``sd`` and JAX's draws -> (model, step,
    total, loss terms)."""
    model = port_model(cfg)
    model.load_state_dict(sd, strict=True)
    step = TrainStep(model, cfg)
    total, losses, _ = step.loss_and_grads({k: torch.from_numpy(v) for k, v in batch.items()},
                                           Replay(draws))
    return model, step, total.item(), {k: v.item() for k, v in losses.items()}


def test_amp_step_keeps_fp32_masters_and_matches_jax_losses(amp):
    """One AMP step on JAX's draws, its discrete choices (kept tokens, splits,
    sampling cells, attention masks, ranked points, matches) replayed from
    the fp32 step's (which equals JAX's fp32 step to 1e-5 in the fp32
    tests): the masters, their gradients, the AdamW moments and the
    BatchNorm statistics stay fp32, and every loss term and the total lie
    within 10 % of JAX's AMP step (2e-3 for a term near 0).  Without the
    replay, bf16 rounding flips near-tied choices in one run or the other
    and a term can move by half (MRML's first matching at this size)."""
    from chip_smoke import same_choices

    cfg = amp["cfg"]
    fp32 = cfg.clone()
    fp32.SOLVER.AMP.ENABLED = False
    book = {}
    with same_choices(book, record=True):
        port_step_losses(fp32, amp["sd"], amp["batch"], amp["draws"])
    with same_choices(book, record=False):
        model, step, total, losses = port_step_losses(cfg, amp["sd"], amp["batch"],
                                                      amp["draws"])
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    grad_norm = step.apply_gradients()
    assert np.isfinite(total) and torch.isfinite(grad_norm)
    for state in step.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in state.values() if v.is_floating_point())
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())
    want = amp["metrics"]
    assert set(losses) == set(want) - {"total_loss", "grad_norm"}
    for k, got, w in [(k, v, want[k]) for k, v in losses.items()] + [
            ("total", total, want["total_loss"])]:
        assert abs(got - w) <= max(LOSS_RTOL * abs(w), LOSS_ATOL), (k, got, w)


# ------------------------------------------------------------------ islands
@pytest.mark.parametrize("arch", list(ARCHS))
def test_island_keep_sets_match_jax(arch):
    """For each island (and none), the parameters the bf16 view keeps fp32
    are exactly the ones JAX's ``amp_variables`` keeps, by the weights
    bridge's names (MaskFormer build functions: the built model's own view)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.parallel.precision import KEEP_F32, cast_floating

    cfg = amp_cfg(arch)
    model = port_model(cfg)
    size = ARCHS[arch][1]
    jm = jax_model(cfg)
    args = (jnp.zeros((1, size, size, 3)),) + ((jnp.zeros((1, size, size), jnp.int32),)
                                               if with_gt(cfg) else ())
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "oracle": jax.random.PRNGKey(1)}, *args))["params"]
    named = dict(model.named_parameters())
    for island in ((),) + tuple((i,) for i in ISLANDS):
        from autofocusformermod_tpu.parallel.precision import ISLAND_PARAM_PATHS

        jkeep = KEEP_F32 + sum((ISLAND_PARAM_PATHS[i] for i in island), ())
        cast = cast_floating(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
                             keep_f32=jkeep)
        want = {torch_name(p) for p, v in _walk(cast) if v.dtype == jnp.float32}
        view = precision.cast_floating(named, keep_f32=precision.KEEP_F32
                                       + precision.island_keep_paths(island))
        got = {n for n, t in view.items() if t.dtype == torch.float32}
        assert got == want, (island, sorted(got ^ want)[:6])
        if island == ():
            assert any("sampling_offsets" in n for n in got) or arch == "r50" and not got


@pytest.mark.parametrize("island", ISLANDS)
def test_islands_run_as_in_jax(island, monkeypatch):
    """Under AFF_F32_ISLANDS the AFF MaskFormer's view keeps the island's
    parameters fp32 and each module computes in JAX's dtype; the other
    meta-architectures, whose JAX modules make no island casts, refuse."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.parallel.precision import amp_variables

    monkeypatch.setenv("AFF_F32_ISLANDS", island)
    cfg = amp_cfg("aff")
    model = port_model(cfg)
    assert model.f32_islands == (island,)
    view = precision.amp_parameters(model)
    kept = {n for n, t in view.items() if t.dtype == torch.float32}
    assert kept and all(any(k in n for k in precision.KEEP_F32
                            + precision.ISLAND_PARAM_PATHS[island]) for n in kept)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    jm = jax_model(cfg)
    x = np.random.default_rng(0).integers(0, 256, (B, 128, 128, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xf))
    variables = jax.tree.map(jnp.asarray, {k: torch_to_flax(v, sd) for k, v in shapes.items()})
    out, inter = jax.eval_shape(lambda v: jm.apply(amp_variables(v), xf, train=False,
                                                   capture_intermediates=True), variables)
    jd = jax_module_dtypes(inter["intermediates"])
    pout, pd, _, operands = port_forward(model, (torch.from_numpy(x),))
    common = set(jd) & set(pd)
    assert len(common) >= 30
    assert {n: pd[n] for n in common if pd[n] != jd[n]} == {}
    assert any("float32" in pd[n] and "bfloat16" not in pd[n] for n in common
               if any(k in n + "." for k in precision.ISLAND_PARAM_PATHS[island]))
    assert _float_dtypes(pout) == {"float32"} and operands == {"float32"}
    for other in ("maskfiner", "oracle_teacher_bb", "maskformer_ml"):
        with pytest.raises(NotImplementedError, match="islands"):
            port_model(amp_cfg(other))


def test_maskformer_swin_stays_fp32():
    """JAX's maskformer_swin_from_config gives its MaskFormer no compute
    dtype: under AMP it stays fp32 (Trainer.test() casts nothing), and the
    port's does too."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.meta_arch_variants import maskformer_swin_from_config

    from test_torch_swin import tiny_swin_cfg

    cfg = tiny_swin_cfg()
    cfg.SOLVER.AMP.ENABLED = True
    assert maskformer_swin_from_config(cfg).compute_dtype == jnp.float32
    model = port_model(cfg)
    assert model.compute_dtype == torch.float32 and not precision.uses_amp(model)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 96, 96, 3))
                         .astype(np.uint8))
    out, dtypes, _, _ = port_forward(model, (x,))
    assert set().union(*dtypes.values()) == {"float32"}
    assert _float_dtypes(out) == {"float32"}


def test_updown_tiny_coco_panoptic_preset_matches_yaml():
    """The ``maskfiner_updown_tiny_coco_panoptic`` preset equals
    ``configs/coco/panoptic-segmentation/maskfiner/maskfiner_updown_tiny_bs16_50ep.yaml``
    merged over its two bases and the defaults, field by field, AMP on;
    but SEM_SEG_HEAD.NUM_CLASSES, which the yaml leaves at the default 150
    while evaluation reads it for the class count: the preset carries the
    model's 133."""
    from test_torch_resnet import check_preset_matches_yaml

    from autofocusformermod_torch.config import PRESETS

    name = "maskfiner_updown_tiny_coco_panoptic"
    preset = PRESETS[name]()
    assert preset.MODEL.SEM_SEG_HEAD.NUM_CLASSES == preset.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES == 133
    real = PRESETS[name]

    def as_yaml_leaves_it():
        cfg = real()
        cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 150
        return cfg

    PRESETS[name] = as_yaml_leaves_it
    try:
        seen = check_preset_matches_yaml(name, "configs/coco/panoptic-segmentation/maskfiner/"
                                               "maskfiner_updown_tiny_bs16_50ep.yaml")
    finally:
        PRESETS[name] = real
    assert {"SOLVER.AMP.ENABLED", "MODEL.MR.EMBED_DIM", "MODEL.MR.DEPTHS",
            "MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES", "INPUT.DATASET_MAPPER_NAME",
            "INPUT.IMAGE_SIZE", "MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD",
            "DATASETS.TEST"} <= seen
    assert preset.SOLVER.AMP.ENABLED and list(preset.MODEL.MR.EMBED_DIM) == [
        512, 256, 128, 64, 128, 256, 512]
