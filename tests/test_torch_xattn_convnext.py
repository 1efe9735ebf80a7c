"""The PyTorch port's MixResNeighbourXAttn and ConvNeXtV2 stages, a
MixResNeighbour first stage, the 4-stage ConvNeXtV2, the cascade over them
and the eval-time dynamic split ratios, against the JAX package.

Every module is built in the port from a torch seed, its weights
randomised by ``init_random_weights`` (so GRN's zero-initialised gamma and
beta and the BatchNorm statistics are not trivial), and carried to JAX with
``torch_to_flax`` over ``jax.eval_shape`` of the JAX module's init (no JAX
init).  Inputs come from numpy seeds; both sides run in fp32 on the CPU,
the JAX side compiled by ``fast_jit``.  Tolerance: every output within
1e-4 of its largest |entry| (fp32 summation order; measured differences
~1e-6 to 1e-5); gradients as ``tests/test_torch_maskfiner_train.py`` holds
them, rtol 1e-3 and atol 1e-4 of the parameter's largest entry plus 1e-5
(measured: at worst 1.3e-4 of the largest entry), and the same parameters
without a gradient; token positions, segment sizes and split counts
equal.

The tiny cascade is ``tests/test_maskfiner.py``'s (3 stages, 64x64, batch
2, clusters of 8 over 2-cluster neighbourhoods) with MR.NAME ["ConvNeXtV2",
"MixResNeighbourXAttn", "MixResNeighbourXAttn"].
"""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict, torch_name
from autofocusformermod_torch.models.convnextv2 import ConvNeXtV2, ConvNeXtV2Stage
from autofocusformermod_torch.models.maskfiner import (build_backbone_indexed,
                                                       maskfiner_dynamic_eval,
                                                       maskfiner_from_config)
from autofocusformermod_torch.models.maskformer import init_random_weights
from autofocusformermod_torch.models.mixres import MixResNeighbour, dynamic_k_split
from autofocusformermod_torch.models.registry import build_model

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_mrml import fast_jit
from test_torch_updown import torch_to_flax

REL = 1e-4
NAMES = ["ConvNeXtV2", "MixResNeighbourXAttn", "MixResNeighbourXAttn"]


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} against largest |entry| {scale}"


def seeded(module):
    return init_random_weights(module, torch.Generator().manual_seed(0))


def jax_variables(jmodule, port, *args, whole=False, **kwargs):
    """The JAX variables of ``jmodule`` (its init traced on ``args``) filled
    from the port module's state dict.  The bridge names a module's own
    leaves under a parent, so a part of a model (not ``whole``) sits under
    one, "m", on both sides."""
    import jax

    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kwargs))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    if whole:
        return {k: torch_to_flax(v, sd) for k, v in shapes.items()}
    sd = {"m." + k: v for k, v in sd.items()}
    return {k: torch_to_flax({"m": v}, sd)["m"] for k, v in shapes.items()}


def stream(rng, b, side, step, c):
    """A full-grid token stream: features (b, side^2, c), (scale 0, x, y)
    positions of a side x side grid of pitch `step`, raster order."""
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="xy")
    pos = np.zeros((b, side * side, 3), np.float32)
    pos[:, :, 1], pos[:, :, 2] = gx.reshape(-1) * step, gy.reshape(-1) * step
    return rng.standard_normal((b, side * side, c)).astype(np.float32), pos


def _compare_outs(got, want, what):
    assert {k for k in got if not k.endswith("spatial_shape")} == {
        k for k in want if not k.endswith("spatial_shape")}
    for key, w in want.items():
        if key.endswith("spatial_shape") or key == "min_spatial_shape":
            assert tuple(got[key]) == tuple(w), key
        else:
            _close(got[key], w, what=f"{what} {key}")


# ------------------------------------------------------------ the stage modules
def test_xattn_neighbour_matches_jax():
    """The XAttn stage at tests/test_maskfiner.py's shapes (scale 1 of 3,
    patches 16 and 8 at 64x64, 16 incoming tokens split 4-way at ratio
    0.25), two blocks, each preceded by the newest tokens' cross-attention
    to their patch features."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mixres import MixResNeighbour as JNeighbour

    kw = dict(scale=1, n_scales=3, patch_sizes=(16, 8), min_patch_size=4, d_model=32,
              n_layers=2, n_heads=2, nbhd_size=16, mlp_ratio=1.0, in_channels=24)
    torch.manual_seed(0)
    port = seeded(MixResNeighbour(**kw, cross_attend_image=True)).eval()
    jmod = JNeighbour(**kw, first_layer=False, cross_attend_image=True)
    rng = np.random.default_rng(0)
    im = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    feats, pos = stream(rng, 2, 4, 4, 24)
    mask = rng.standard_normal((2, 16)).astype(np.float32)
    args = [jnp.asarray(a) for a in (im, feats, pos, mask)]
    variables = jax_variables(jmod, port, *args, (16,), False)
    assert any(k.startswith("x_attn") for k in variables["params"]["layers"])
    assert "x_attn_patcher" in variables["params"]
    want, want_tps = fast_jit(lambda v, *a: jmod.apply(v, *a, (16,), False), variables,
                              *args)(variables, *args)
    with torch.no_grad():
        got, tps = port(*(torch.from_numpy(a) for a in (im, feats, pos, mask)), (16,))
    assert tps == tuple(want_tps) == (16, 16)
    _compare_outs(got, want, "xattn")


@pytest.mark.parametrize("train", [False, True])
def test_first_layer_neighbour_matches_jax(train):
    """A MixResNeighbour first stage (BatchNorm patch embedding, sine
    position embedding, cluster attention over 64 tokens of patch 16 at
    128x128); in train mode the BatchNorm normalises by the batch and its
    running statistics move as flax's."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mixres import MixResNeighbour as JNeighbour

    kw = dict(scale=0, n_scales=3, patch_sizes=(16,), min_patch_size=4, d_model=32, n_layers=1,
              n_heads=2, nbhd_size=16, mlp_ratio=1.0, in_channels=3)
    torch.manual_seed(0)
    port = seeded(MixResNeighbour(**kw, first_layer=True)).train(train)
    jmod = JNeighbour(**kw, first_layer=True, do_upsample=False)
    im = np.random.default_rng(1).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    variables = jax_variables(jmod, port, jnp.asarray(im), None, None, None, None, False)
    assert set(variables) == {"params", "batch_stats"}

    def apply(v, x):
        return jmod.apply(v, x, None, None, None, None, train, mutable=["batch_stats"])

    (want, want_tps), stats = fast_jit(apply, variables, jnp.asarray(im))(variables,
                                                                          jnp.asarray(im))
    with torch.no_grad():
        got, tps = port(torch.from_numpy(im), None, None, None, None)
    assert tps == tuple(want_tps) == (64,)
    _compare_outs(got, want, "first layer")
    got_stats = flax_to_torch_state_dict({}, {"m": stats["batch_stats"]})
    assert len(got_stats) == 4 * 3                  # four BatchNorms: mean, var, count
    for name, value in got_stats.items():
        if not name.endswith("num_batches_tracked"):
            _close(port.state_dict()[name[2:]], value, what=name)


@pytest.mark.parametrize("first", [True, False])
def test_convnextv2_stage_matches_jax(first):
    """The ConvNeXtV2 cascade stage: first (the overlapping patch embedding
    at patch 16 of 64x64, two blocks, the sine embedding after them) or
    later (LayerNorm + projection of a 24-wide stream of the full 8 x 8
    grid of patch 8); a later stage on a partial stream raises, as JAX
    asserts."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.convnextv2 import ConvNeXtV2Stage as JStage

    kw = (dict(scale=0, patch_size=16, in_channels=3) if first
          else dict(scale=1, patch_size=8, in_channels=24))
    kw.update(n_scales=3, min_patch_size=4, d_model=32, n_layers=2, first_layer=first)
    torch.manual_seed(0)
    port = seeded(ConvNeXtV2Stage(**kw)).eval()
    jmod = JStage(**kw, out_feature=f"res{3 - kw['scale'] + 1}")
    rng = np.random.default_rng(2)
    im = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    feats, pos = (None, None) if first else stream(rng, 2, 8, 2, 24)
    tps = None if first else (64,)
    jargs = [jnp.asarray(im)] + [None if a is None else jnp.asarray(a) for a in (feats, pos)]
    variables = jax_variables(jmod, port, *jargs, None, tps, False)
    assert np.abs(variables["params"]["stage_1"]["grn"]["gamma"]).max() > 0
    want, want_tps = fast_jit(lambda v, *a: jmod.apply(v, *a, None, tps, False), variables,
                              *jargs)(variables, *jargs)
    targs = [torch.from_numpy(im)] + [None if a is None else torch.from_numpy(a)
                                      for a in (feats, pos)]
    with torch.no_grad():
        got, got_tps = port(*targs, None, tps, k_split=3)
    assert tuple(got_tps) == tuple(want_tps)
    _compare_outs(got, want, "convnextv2 stage")
    if not first:
        with pytest.raises(ValueError, match="full 8 x 8 patch grid"):
            port(targs[0], targs[1][:, :60], targs[2][:, :60], None, (60,))


def test_convnextv2_backbone_matches_jax():
    """The 4-stage ConvNeXtV2 (depths 1, 1, 2, 1, widths 8-32, DropPath
    ramp to 0.1 off in eval) on 64x64: every res{i+2}, its positions on the
    stem's grid, scales and spatial shapes."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.convnextv2 import ConvNeXtV2 as JConvNeXtV2

    kw = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), drop_path_rate=0.1)
    torch.manual_seed(0)
    port = seeded(ConvNeXtV2(**kw)).eval()
    jmod = JConvNeXtV2(**kw)
    im = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jax_variables(jmod, port, jnp.asarray(im), False)
    want = fast_jit(lambda v, x: jmod.apply(v, x, False), variables,
                    jnp.asarray(im))(variables, jnp.asarray(im))
    with torch.no_grad():
        got = port(torch.from_numpy(im))
    assert set(got) == set(want) and len(got) == 16
    _compare_outs(got, want, "convnextv2")


# ------------------------------------------------------------ the cascade
def tiny_cfg(names=NAMES):
    from test_maskfiner import tiny_maskfiner_cfg

    cfg = tiny_maskfiner_cfg()
    cfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    cfg.MODEL.MR.NAME = list(names)
    return cfg


class CompiledStages:
    """A JAX MaskFiner whose ``apply`` compiles each call (``fast_jit``, the
    stage index, segment sizes and split count static), for JAX's
    ``maskfiner_dynamic_eval``, which applies one stage at a time (op by op
    it takes ~55 s here)."""

    def __init__(self, model):
        self.model, self.mask_predictors = model, model.mask_predictors

    def apply(self, variables, idx, images, features, features_pos, upsampling_mask,
              tokens_per_scale, k_split, method):
        def stage(v, im, f, fp, um):
            return self.model.apply(v, idx, im, f, fp, um, tokens_per_scale, k_split,
                                    method=method)

        args = (variables, images, features, features_pos, upsampling_mask)
        if tokens_per_scale is not None:
            tokens_per_scale = tuple(int(t) for t in tokens_per_scale)
        *out, seg_sizes, tps = fast_jit(stage, *args)(*args)
        # the segment sizes come back as arrays: static ints again
        return (*out, tuple(int(t) for t in seg_sizes), tps)


@pytest.fixture(scope="module")
def cascade():
    """The tiny XAttn / ConvNeXtV2 cascade: the port's seeded weights (class
    head perturbed by more, so the queries vote different classes) in JAX;
    JAX's eval forward, the gradient of a loss over every mask output, and
    the dynamic eval with the default buckets at threshold 0.5."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import maskfiner_dynamic_eval as jdynamic
    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jmaskfiner

    cfg = tiny_cfg()
    torch.manual_seed(0)
    model = seeded(maskfiner_from_config(cfg)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)))
    jmodel = jmaskfiner(cfg)
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax_variables(jmodel, model, xf, whole=True, train=False)

    def loss(params, im):
        o = jmodel.apply({"params": params}, im, train=False)
        masks = [o["pred_masks"]] + [a["pred_masks"] for a in o["aux_outputs"]]
        return sum(jnp.sum(m * w) for m, w in zip(masks, loss_weights(masks))), o

    fn = jax.value_and_grad(loss, has_aux=True)
    (_, out), grads = fast_jit(fn, variables["params"], xf)(variables["params"], xf)
    dyn = jdynamic(CompiledStages(jmodel), variables, xf)
    return {"cfg": cfg, "model": model, "x": x, "variables": variables,
            "out": jax.tree.map(np.asarray, out), "grads": grads,
            "dyn": jax.tree.map(np.asarray, dyn)}


def test_tiny_cascade_forward_matches_jax(cascade):
    """Final and aux outputs, every stage's disagreement and the last
    stage's positions (equal: the same tokens split in the same order)."""
    with torch.no_grad():
        got = cascade["model"](torch.from_numpy(cascade["x"]))
    want = cascade["out"]
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 6
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            _close(a[key], w[key], what=f"aux {i} {key}")
    for i, (d, w) in enumerate(zip(got["disagreement_masks"], want["disagreement_masks"])):
        assert w.max() > 0
        _close(d, w, what=f"disagreement {i}")
    np.testing.assert_array_equal(got["features_pos"].numpy(), want["features_pos"])


def loss_weights(masks):
    """Fixed random weights (numpy seed 5), one per entry of each mask
    output: the loss is linear in the outputs."""
    rng = np.random.default_rng(5)
    return [rng.standard_normal(tuple(m.shape)).astype(np.float32) for m in masks]


def test_tiny_cascade_gradients_match_jax(cascade):
    """The gradient of a fixed random linear function of every output's
    mask logits, for every parameter (XAttn, ConvNeXtV2 and the split's
    straight-through path included); the class heads, which reach the
    masks only through the disagreement's class votes, get none on either
    side."""
    import jax

    model = cascade["model"]
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(cascade["x"]))
    masks = [out["pred_masks"]] + [a["pred_masks"] for a in out["aux_outputs"]]
    sum((m * torch.from_numpy(w)).sum() for m, w in zip(masks, loss_weights(masks))).backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    # JAX's gradients in the port's names and layouts (the bridge packs an
    # attention layer's three projections)
    want = flax_to_torch_state_dict(jax.tree.map(np.asarray, cascade["grads"]))
    assert set(want) == set(got)
    for name, w in want.items():
        w = w.numpy()
        if got[name] is None:
            assert not w.any() and "class_embed" in name, name
            continue
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-5, err_msg=name)
    assert sum(g is None for g in got.values()) == 6
    assert all(float(g.abs().max()) > 0 for n, g in got.items() if "x_attn" in n or ".grn." in n)
    model.zero_grad(set_to_none=True)


def test_dynamic_eval_matches_jax(cascade):
    """maskfiner_dynamic_eval with the default buckets at threshold 0.5:
    each later stage's split count from its predecessor's disagreement, the
    outputs and the last stage's positions, against JAX's."""
    got = maskfiner_dynamic_eval(cascade["model"], torch.from_numpy(cascade["x"]))
    want = cascade["dyn"]
    n_tokens = [int(w.shape[1]) for w in want["disagreement_masks"][:-1]]
    assert [d.shape[1] for d in got["disagreement_masks"][:-1]] == n_tokens
    assert got["k_splits"][0] is None and all(k >= 1 for k in got["k_splits"][1:])
    np.testing.assert_array_equal(got["features_pos"].numpy(), want["features_pos"])
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    for i, (d, w) in enumerate(zip(got["disagreement_masks"], want["disagreement_masks"])):
        _close(d, w, what=f"disagreement {i}")


def test_dynamic_eval_at_the_static_ratio_is_the_forward(cascade):
    """With the one bucket 0.25 (the static UPSCALE_RATIO) the dynamic eval
    is the static forward, and with threshold -inf and buckets (0.25, 1.0)
    every token of the newest scale splits."""
    x = torch.from_numpy(cascade["x"])
    with torch.no_grad():
        static = cascade["model"](x)
    dyn = maskfiner_dynamic_eval(cascade["model"], x, buckets=(0.25,))
    for key in ("pred_logits", "pred_masks", "features_pos"):
        assert torch.equal(dyn[key], static[key]), key
    full = maskfiner_dynamic_eval(cascade["model"], x, threshold=-1e9, buckets=(0.25, 1.0))
    assert full["k_splits"] == (None, 16, 64)
    assert full["features_pos"].shape[1] > static["features_pos"].shape[1]


@pytest.mark.parametrize("case", ["bucket", "floor", "cap", "random"])
def test_dynamic_k_split_matches_jax(case):
    """JAX's cases (tests/test_maskfiner.py: a share of 0.37 rounds up to
    0.5, none floors at 0.1, a cap of 0.25) and seeded random scores at
    several thresholds and bucket sets, against JAX's function."""
    from autofocusformermod_tpu.models.mixres import dynamic_k_split as jdynamic_k_split

    if case == "bucket":
        scores = np.zeros((2, 100))
        scores[0, :37] = 1.0
        assert dynamic_k_split(scores, 100, threshold=0.5) == 50
    elif case == "floor":
        assert dynamic_k_split(np.zeros((1, 100)), 100, threshold=0.5) == 10
    elif case == "cap":
        assert dynamic_k_split(np.ones((1, 100)), 100, threshold=0.5, cap_ratio=0.25) == 25
    else:
        rng = np.random.default_rng(4)
        for _ in range(40):
            n = int(rng.integers(1, 300))
            scores = rng.standard_normal((int(rng.integers(1, 4)), n)).astype(np.float32)
            kw = dict(threshold=float(rng.normal()), cap_ratio=float(rng.uniform(0.05, 1.0)),
                      buckets=tuple(rng.uniform(0.05, 1.0, int(rng.integers(1, 5)))))
            assert dynamic_k_split(scores, n, **kw) == jdynamic_k_split(
                scores, n, **kw), kw


# ------------------------------------------------------------ build, AMP
@pytest.mark.parametrize("name", ["MixResViT", "MixResNeighbour", "MixResNeighbourXAttn",
                                  "ConvNeXtV2"])
@pytest.mark.parametrize("stage", [0, 1])
def test_build_model_builds_each_name_as_jax(name, stage):
    """Each name at stage 0 and at a later stage builds, on the CPU and on
    the meta device, JAX's parameter tree (names and shapes through the
    bridge); an unknown name raises KeyError, as JAX's builder does."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import build_backbone_indexed as jbuild

    cfg = tiny_cfg(["MixResViT", "MixResNeighbour", "MixResNeighbour"])
    cfg.MODEL.MR.NAME[stage] = name
    model = build_model(cfg)
    with torch.device("meta"):
        meta = build_model(cfg)
    assert all(p.is_meta for p in meta.parameters())
    assert {k: v.shape for k, v in meta.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    port = build_backbone_indexed(cfg, stage)
    jmod = jbuild(cfg, stage)
    im = jnp.zeros((1, 64, 64, 3), jnp.float32)
    if stage == 0:
        args = (im, None, None, None, None)
    else:
        n = 16 if name in ("MixResNeighbour", "MixResNeighbourXAttn") else (64 // 8) ** 2
        pos = jnp.zeros((1, n, 3), jnp.float32)
        args = (im, jnp.zeros((1, n, 32), jnp.float32), pos, jnp.zeros((1, n)), (n,))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, False))
    want = {torch_name(("m",) + tuple(p.key for p in path)) for tree in shapes.values()
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    sd = {"m." + k: v for k, v in port.state_dict().items()}
    assert want == {k for k in sd if not k.endswith("num_batches_tracked")}
    for tree in shapes.values():
        torch_to_flax({"m": tree}, sd)            # asserts every leaf's shape
    cfg.MODEL.MR.NAME[stage] = "MixResNeighbourBogus"
    with pytest.raises(KeyError, match="MixResNeighbourBogus"):
        build_model(cfg)


def test_amp_dtypes_of_the_new_parameters_match_jax(cascade):
    """Under SOLVER.AMP.ENABLED the port's bf16 view of the cascade
    (precision.amp_parameters) gives each parameter JAX's amp_variables
    dtype on the same tree (no JAX AMP forward is compiled): the new
    stages' parameters (ConvNeXtV2's GRN, the XAttn attention and patcher)
    included."""
    import jax

    from autofocusformermod_torch.parallel.precision import amp_parameters
    from autofocusformermod_tpu.parallel.precision import amp_variables

    cfg = tiny_cfg()
    cfg.SOLVER.AMP.ENABLED = True
    model = maskfiner_from_config(cfg)
    view = amp_parameters(model)
    amp = amp_variables({"params": jax.tree.map(jax.numpy.asarray,
                                                cascade["variables"]["params"])})
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(amp["params"])[0]:
        name = torch_name(tuple(p.key for p in path))
        want = torch.bfloat16 if str(leaf.dtype) == "bfloat16" else torch.float32
        assert view[name].dtype == want, name
        seen.add(name)
    assert seen == set(view)
    assert any(".grn.gamma" in n for n in seen) and any("x_attn_patcher" in n for n in seen)
