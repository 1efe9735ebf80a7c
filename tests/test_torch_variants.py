"""Options of the ported models against the JAX package, one parametrised
test per family, each a tiny forward in fp32 on the CPU with the weights
carried over:

  - the MaskFiner options: the pre-norm decoder, the Cat decoder (every
    round attends to all levels at once), the SingleScale decoder name, the
    HierUp pixel decoder (its FPN level painted onto the whole grid), the
    projection pixel decoder under the plain MaskPredictor head, and
    MASK_DECODER_ALL_LEVELS under the OracleTeacher head (a decoder on every
    stage); ``test_maskfiner.py``'s tiny cascade (64x64, batch 2), or
    ``test_torch_oracle_teacher.py``'s, seeded in the port, its JAX tree by
    ``jax.eval_shape`` filled from the port's weights;
  - register tokens: the port builds JAX's parameter tree (zeros), and the
    forward raises where JAX's does (the depthwise conv of stage 0's
    feed-forward meets h * w + R tokens);
  - AFF without the reserved grid, with clusters larger than the
    neighbourhood, and with every token its own cluster
    (``test_torch_model.py``'s tiny MaskFormer at 128x128);
  - PointConv on full grids narrower than 3 (2 x N, N x 2, 1 x N);
  - the Peano and Hilbert orders and clustering along them.

Tolerance: rtol = atol = 1e-4 on outputs (fp32 over ~15 layers), as
``test_torch_model.py`` and ``test_torch_maskfiner.py``; positions and
ranks exactly equal.
"""

import numpy as np
import pytest
import torch

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from autofocusformermod_torch.config import CfgNode
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.models.registry import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
B, SIZE = 2, 64


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def _set(cfg, fields):
    for field, value in fields.items():
        *parents, leaf = field.split(".")
        node = cfg
        for name in parents:
            node = getattr(node, name)
        setattr(node, leaf, value)
    return cfg


# ---------------------------------------------------------------- MaskFiner
STD, HIERUP = "MSDeformAttnPixelDecoderMaskFiner", "MSDeformAttnPixelDecoderMaskFinerHierUp"
PROJ, DEC = "ProjMaskFinerOracleTeacher", "MultiScaleMaskFinerTransformerDecoder"
MASKFINER_CASES = {
    "pre_norm": ("plain", {"MODEL.MASK_FINER.PRE_NORM": True}),
    "cat": ("plain", {"MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME": DEC + "Cat"}),
    "single_scale": ("plain", {"MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME": DEC + "SingleScale"}),
    "hierup": ("plain", {"MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME": [STD, STD, HIERUP]}),
    "proj_under_plain_head": ("plain", {"MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME":
                                        [STD, STD, PROJ]}),
    "all_levels_oracle_teacher": ("ot", {"MODEL.MASK_FINER.MASK_DECODER_ALL_LEVELS": True,
                                         "MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME": DEC}),
}


def maskfiner_case_cfg(case):
    kind, fields = MASKFINER_CASES[case]
    if kind == "plain":
        from test_maskfiner import tiny_maskfiner_cfg

        cfg = tiny_maskfiner_cfg()
        cfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    else:
        from test_torch_oracle_teacher import tiny_cfg

        cfg = tiny_cfg()
    return _set(cfg, fields)


def seeded_port(cfg):
    """The port model of ``cfg`` from a torch seed, the class heads
    perturbed by more (so that queries vote for different classes)."""
    from test_torch_updown import seeded_port as seeded

    return seeded(cfg).eval()


def jax_forward(cfg, sd, x):
    """The JAX model of ``cfg`` on the port's weights ``sd`` (its tree by
    ``jax.eval_shape``): the eval forward of the uint8 images ``x``."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import build_model as jax_build
    from test_torch_mrml import fast_jit
    from test_torch_updown import torch_to_flax

    model = jax_build(cfg)
    xf = jnp.asarray(x.astype(np.float32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), xf, train=False))
    params = torch_to_flax(shapes["params"], sd)

    def apply(p):
        return model.apply({"params": p}, xf, train=False)

    return params, jax.tree.map(np.asarray, fast_jit(apply, params)(params))


@pytest.mark.parametrize("case", sorted(MASKFINER_CASES))
def test_maskfiner_option_matches_jax(case):
    """The option builds in the port with JAX's parameter tree (the bridge
    maps every leaf, ``strict``), and the eval forward equals JAX's: the
    final logits and masks, every aux output, each stage's disagreement."""
    pytest.importorskip("jax")
    cfg = maskfiner_case_cfg(case)
    port = seeded_port(CfgNode(cfg))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    x = np.random.default_rng(0).integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    params, want = jax_forward(cfg, sd, x)
    port.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) > 0
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            _close(a[key], w[key], f"aux {i} {key}")
    for key in ("disagreement_masks", "upsampling_preds"):
        for i, (a, w) in enumerate(zip(got.get(key, ()), want.get(key, ()))):
            if w is not None:
                _close(a, w, f"{key} {i}")
    if "features_pos" in want:
        np.testing.assert_array_equal(got["features_pos"].numpy(), want["features_pos"])
    if case == "all_levels_oracle_teacher":
        assert all(p.mask_decoder is not None for p in port.mask_predictors)
        assert len(got["aux_outputs"]) == sum(cfg.MODEL.MASK_FINER.DEC_LAYERS) - 1


# ----------------------------------------------------------- register tokens
@pytest.mark.parametrize("arch", ["MaskFiner", "MaskFinerOracleTeacherBB"])
def test_register_tokens_build_as_jax_and_raise_where_jax_raises(arch):
    """MODEL.MR.NUM_REGISTER_TOKENS 2: stage 0 (MixResViT) holds a zero
    ``register_tokens`` parameter of (1, 2, width), the whole tree equal to
    JAX's, and a forward raises in both packages: the tokens are prepended
    before the blocks, whose depthwise conv reshapes h * w + 2 tokens onto
    the h x w grid (JAX: a TypeError of the reshape)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import build_model as jax_build
    from test_torch_updown import torch_to_flax

    if arch == "MaskFiner":
        from test_maskfiner import tiny_maskfiner_cfg

        cfg = tiny_maskfiner_cfg()
        cfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    else:
        from test_torch_updown import tiny_cfg

        cfg = tiny_cfg()
    cfg.MODEL.MR.NUM_REGISTER_TOKENS = 2
    port = build_model(CfgNode(cfg)).eval()
    stage0 = (port.mask_predictors[0].backbone if arch == "MaskFiner"
              else port.backbone.backbones[0])
    assert torch.equal(stage0.register_tokens.detach(), torch.zeros(1, 2, cfg.MODEL.MR.EMBED_DIM[0]))
    x = np.zeros((B, SIZE, SIZE, 3), np.float32)
    model = jax_build(cfg)
    init = lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)  # noqa: E731
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(init)
    # JAX's tree without the forward: the port's state dict back through the
    # bridge lands on every leaf of a tree built from the port's names
    sd = port.state_dict()
    assert any(k.endswith("register_tokens") for k in sd)
    with pytest.raises(ValueError, match="register tokens"):
        with torch.no_grad():
            port(torch.from_numpy(x))
    cfg.MODEL.MR.NUM_REGISTER_TOKENS = 0
    shapes = jax.eval_shape(lambda: jax_build(cfg).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                        train=False))
    without = {k for k in sd if not k.endswith("register_tokens")}
    assert set(flax_to_torch_state_dict(torch_to_flax(shapes["params"], sd))) == without


# ----------------------------------------------------------------------- AFF
AFF_CASES = {"reserve_off": {"MODEL.AFF.RESERVE": False},
             "cluster_larger_than_neighbourhood": {"MODEL.AFF.CLUSTER_SIZE": 16,
                                                   "MODEL.AFF.NBHD_SIZE": [12, 12, 12, 12]},
             "every_token_its_own_cluster": {"MODEL.AFF.CLUSTER_SIZE": 1}}


@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_aff_option_matches_jax(case):
    """The tiny AFF MaskFormer of ``test_torch_model.py`` (128x128: stages
    of 1024, 256, 64 and 16 tokens) with the option, on the port's seeded
    weights carried by the JAX package's converter: every stage's features
    and kept positions, the final logits and masks."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_torch.models.maskformer import (init_random_weights,
                                                            maskformer_from_config)
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from test_torch_model import tiny_cfg
    from test_torch_mrml import fast_jit
    from test_torch_train import _flax_tree

    cfg = _set(tiny_cfg(), AFF_CASES[case])
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    model.eval()
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    flat_p, flat_s = convert_reference_state_dict(sd)
    variables = {"params": _flax_tree(flat_p), "batch_stats": _flax_tree(flat_s)}
    x = np.random.default_rng(0).integers(0, 256, (B, 128, 128, 3)).astype(np.uint8)
    jmodel = jax_maskformer(cfg)
    xf = jnp.asarray(x.astype(np.float32))

    def apply(v):
        out, state = jmodel.apply(v, xf, train=False, capture_intermediates=lambda m, n: (
            n == "__call__" and m.name == "backbone"))
        feats = state["intermediates"]["backbone"]["__call__"][0]
        return out, {k: w for k, w in feats.items() if not k.endswith("spatial_shape")}

    out, feats = jax.tree.map(np.asarray, fast_jit(apply, variables)(variables))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got_feats = model.backbone(model.normalize(xt))
        got = model(xt)
    for i in range(2, 6):
        np.testing.assert_array_equal(got_feats[f"res{i}_pos"].numpy(), feats[f"res{i}_pos"])
        _close(got_feats[f"res{i}"], feats[f"res{i}"], f"res{i}")
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], out[key], key)


# ----------------------------------------------------------------- PointConv
@pytest.mark.parametrize("h, w", [(2, 7), (6, 2), (1, 10)])
def test_pointconv_on_a_narrow_full_grid_matches_jax(h, w):
    """A full grid narrower than 3 in a shuffled token order: each token's
    exact 9 nearest grid tokens (JAX's ``grid_neighbors9`` route), the
    weights from their truncated offsets, the channel mix."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_torch.models.pixel_decoder import PointConv
    from autofocusformermod_tpu.models.pixel_decoder import PointConv as JaxPointConv

    rng = np.random.default_rng(h * 10 + w)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    pos = np.stack([grid[rng.permutation(h * w)] for _ in range(B)])
    x = rng.standard_normal((B, h * w, 8)).astype(np.float32)
    jconv = JaxPointConv(6)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos), (h, w))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                          .astype(np.float32), params)
    want = jconv.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos), (h, w))
    conv = PointConv(8, 6)
    prefix = "sem_seg_head.pixel_decoder.layer_1.0."
    sd = flax_to_torch_state_dict({"head": {"pixel_decoder": {"layer_1_pointconv": params}}})
    conv.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.from_numpy(pos), (h, w))
    _close(got, want, f"PointConv on {h} x {w}")


# ------------------------------------------------------ Peano and Hilbert
CURVE_CASES = [("peano", 9, 9), ("peano", 9, 18), ("peano", 27, 27), ("peano", 6, 6),
               ("hilbert", 8, 8), ("hilbert", 16, 16), ("hilbert", 12, 12), ("hilbert", 16, 8)]


@pytest.mark.parametrize("curve, h, w", CURVE_CASES)
def test_curve_order_and_clustering_match_jax(curve, h, w):
    """``calculate_{curve}_order`` of random positions on an h x w canvas
    (ranks and argsort equal), and ``space_filling_cluster`` of the full
    grid along the curve (ranking equal, cluster means to 1e-6)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_torch.geometry import cluster as tcluster
    from autofocusformermod_torch.geometry import sfc as tsfc
    from autofocusformermod_tpu.geometry import cluster as jcluster
    from autofocusformermod_tpu.geometry import sfc as jsfc

    rng = np.random.default_rng(h * 100 + w)
    pos = np.stack([rng.integers(0, w, (B, 40)), rng.integers(0, h, (B, 40))],
                   -1).astype(np.float32)
    fn = f"calculate_{curve}_order"
    want = getattr(jsfc, fn)(h, w, jnp.asarray(pos))
    got = getattr(tsfc, fn)(h, w, torch.from_numpy(pos))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)
    for m in (4, 8):
        want = jcluster.space_filling_cluster(jnp.asarray(grid), m, h, w, sf_type=curve)
        got = tcluster.space_filling_cluster(torch.from_numpy(grid), m, h, w, sf_type=curve)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


def test_hilbert_order_of_a_wide_canvas_raises():
    """Wider than 1.25 x its height, the first Hilbert level reads past its
    4-entry table (JAX's gather fills NaN keys there): the port raises."""
    from autofocusformermod_torch.geometry.sfc import calculate_hilbert_order

    with pytest.raises(ValueError, match="4-entry table"):
        calculate_hilbert_order(8, 16, torch.zeros(1, 4, 2))
