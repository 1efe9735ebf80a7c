"""Dropout in the PyTorch port against the JAX package.

JAX draws every ``nn.Dropout`` mask from its ``"dropout"`` key; the port
draws them from its own generator.  So each JAX run here records its masks
(``jax_masks``: a ``flax.linen.intercept_methods`` interceptor hands each
active Dropout's ``out != 0`` to the host by ``jax.debug.callback``, keyed
by the module's path; this works under ``jax.jit`` and ``jax.grad``), and
the port replays them by module path (``replay_masks`` wraps each Dropout's
``keep_mask``; ``jax_path`` names the JAX module a port Dropout's call
stands for).  Every recorded mask must be replayed exactly once.  Where a
dropped input was 0 already (after a ReLU), ``out != 0`` records a drop
either way; the output and the gradient are 0 there in both packages.

Held, each in fp32 on the CPU with the tolerance stated where it is used:
``Mlp``; the deformable encoder layer (its three drops per level); an AFF
block on JAX's gather path (attention probabilities with the blank sink's
column, the projection, the MLP), local and global; a MixRes ViT block
(the feed-forward's two drops); the tiny flagship's whole training step at
MODEL.MASK_FORMER.DROPOUT 0.1 against JAX's ``make_train_step`` (loss
terms, every gradient), with the AFF rates on too; the step at two gloo
ranks against one process; the kernel path's refusal of attention dropout.
"""

import re

import numpy as np
import pytest
import torch

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.models.layers import Dropout, DropPath, Mlp, set_dropout_generator

# one layer's arithmetic in fp32: outputs and gradients to 1e-5 of the
# largest entry (measured ~1e-7)
UNIT_TOL = 1e-5


def jax_masks(store):
    """An interceptor for ``flax.linen.intercept_methods``: every Dropout
    that drops (train mode, rate > 0) appends its keep mask to
    ``store[path]``."""
    import flax.linen as fnn
    import jax

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if (isinstance(m, fnn.Dropout) and context.method_name == "__call__" and m.rate > 0
                and not m.deterministic):
            path = "/".join(m.scope.path)
            jax.debug.callback(lambda keep, p=path: store.setdefault(p, []).append(
                np.asarray(keep)), out != 0)
        return out

    return interceptor


def _scope(prefix: str) -> str:
    """A port module name -> the JAX scope path of the same module."""
    s = re.sub(r"\.(\d+)", r"_\1", prefix).replace(".", "/")
    return re.sub(r"^sem_seg_head/", "head/", s)


def jax_path(name: str, call: int) -> str:
    """The JAX Dropout module that the ``call``-th call of the port Dropout
    ``name`` stands for: the encoder layer's three per level (the JAX layer
    makes one module a call: Dropout_{3 * level + k - 1}), AFF's after the
    patch embedding, an attention's probabilities and projection, an MLP's
    two."""
    m = re.fullmatch(r"(?:(.*)\.transformer\.encoder\.layers\.(\d+)\.)?dropout([123])", name)
    if m:
        leaf = f"Dropout_{3 * call + int(m[3]) - 1}"
        return f"{_scope(m[1])}/encoder_layer_{m[2]}/{leaf}" if m[1] else leaf
    prefix, _, leaf = name.rpartition(".")
    index = {"pos_drop": 0, "attn_drop": 0, "drop1": 0, "proj_drop": 1, "drop2": 1}[leaf]
    return f"{_scope(prefix)}/Dropout_{index}" if prefix else f"Dropout_{index}"


class replay_masks:
    """Within the block, every Dropout of ``model`` keeps the elements the
    JAX run's mask of its path (``jax_path``) kept; on leaving, every mask
    must have been replayed exactly once."""

    def __init__(self, model, masks):
        self.model, self.masks, self.used = model, masks, []

    def __enter__(self):
        for name, m in self.model.named_modules():
            if isinstance(m, Dropout):
                m.keep_mask = self._keep(name)
        return self

    def _keep(self, name):
        calls = [0]

        def keep_mask(shape, device):
            path = jax_path(name, calls[0])
            calls[0] += 1
            (mask,) = self.masks[path]
            assert tuple(mask.shape) == tuple(shape), (path, mask.shape, shape)
            self.used.append(path)
            return torch.from_numpy(np.array(mask)).to(device)

        return keep_mask

    def __exit__(self, *exc):
        for m in self.model.modules():
            if isinstance(m, Dropout):
                del m.keep_mask
        if exc[0] is None:
            assert sorted(self.used) == sorted(self.masks), (
                sorted(set(self.masks) - set(self.used)), self.used)


def _port_sd(params, wrap, strip):
    """A JAX module's params -> the port module's state dict, named through
    the bridge inside the model tree ``wrap`` and cut to the module by
    ``strip``."""
    tree = params
    for key in reversed(wrap):
        tree = {key: tree}
    return {k[len(strip):]: v for k, v in flax_to_torch_state_dict(tree).items()}


def _close(got, want, what, tol=UNIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} against largest |entry| {scale}"


def _unit(jmodule, tmodule, wrap, strip, xs, call, consts=()):
    """``jmodule`` (train mode, its masks recorded) and ``tmodule`` (JAX's
    masks replayed) on the same weights and inputs: the outputs, and the
    gradients of a fixed weighting of them at the inputs ``xs`` (float32
    arrays) and at every parameter.  ``call(xs, consts, det)`` -> the
    module's arguments: JAX's (``det`` its ``deterministic``), or the
    port's (``det`` None; torch tensors in ``xs``)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    jxs = [jnp.asarray(x) for x in xs]
    params = jax.jit(lambda: jmodule.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)},
                                          *call(jxs, consts, True)))()["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
                          .astype(np.float32), params)
    store = {}

    def weighted(outs, arange, cos):
        return sum((o * cos(arange(o.size).reshape(o.shape) * 0.37)).sum() for o in outs)

    def loss(p, inputs):
        with fnn.intercept_methods(jax_masks(store)):
            out = jmodule.apply({"params": p}, *call(inputs, consts, False),
                                rngs={"dropout": jax.random.PRNGKey(7)})
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return weighted(outs, jnp.arange, jnp.cos), outs

    (_, jouts), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jxs)
    assert store, "JAX dropped nothing"

    tmodule.load_state_dict(_port_sd(params, wrap, strip), strict=True)
    tmodule.train()
    txs = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    with replay_masks(tmodule, store):
        out = tmodule(*call(txs, consts, None))
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    sum((o * torch.cos(torch.arange(o.numel(), dtype=torch.float32).reshape(o.shape) * 0.37))
        .sum() for o in outs).backward()
    for i, (o, w) in enumerate(zip(outs, jouts)):
        _close(o.detach(), w, f"output {i}")
    for i, (x, g) in enumerate(zip(txs, jgx)):
        _close(x.grad, g, f"input {i} gradient")
    want = _port_sd(jgp, wrap, strip)
    for name, p in tmodule.named_parameters():
        _close(p.grad, want[name], f"{name} gradient")
    return store


# ------------------------------------------------------------------ units
def test_dropout_is_flax_dropout():
    """Kept elements scaled by 1 / (1 - rate); the identity in eval mode and
    at rate 0; zeros at rate 1; the keep decisions from the generator that
    set_dropout_generator gives, which DropPath shares."""
    x = torch.randn(4, 5, 6)
    d = Dropout(0.3).train()
    set_dropout_generator(d, torch.Generator().manual_seed(0))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) < 0.7
    assert torch.equal(d(x), torch.where(keep, x / 0.7, torch.zeros_like(x)))
    assert torch.equal(Dropout(0.3).eval()(x), x) and torch.equal(Dropout(0.0).train()(x), x)
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))
    box = torch.nn.Sequential(Dropout(0.5), DropPath(0.5))
    gen = torch.Generator().manual_seed(1)
    set_dropout_generator(box, gen)
    assert all(m.generator is gen for m in box)


@pytest.mark.parametrize("drop", [0.25, 0.6])
def test_mlp_matches_jax(drop):
    pytest.importorskip("jax")
    from autofocusformermod_tpu.models.layers import Mlp as JaxMlp

    x = np.random.default_rng(0).standard_normal((2, 9, 6)).astype(np.float32)
    _unit(JaxMlp(12, 5, drop), Mlp(6, 12, 5, drop),
          ("backbone", "layers_0", "blocks_0", "mlp"), "backbone.layers.0.blocks.0.mlp.", [x],
          lambda xs, _, det: (xs[0],) if det is None else (xs[0], det))


def _encoder_inputs(b=2, c=16, levels=((2, 2), (4, 4), (8, 8)), grid=(16, 16)):
    """Level features on full grids (coarse first), their positions, the
    sine embeddings and the packed 4-NN tables of the grid, as the pixel
    decoder makes them."""
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.models.pixel_decoder import (pack_neighbor_table, raster_grid,
                                                               scale_pos)

    rng = np.random.default_rng(1)
    srcs = [rng.standard_normal((b, h * w, c)).astype(np.float32) for h, w in levels]
    embeds = [rng.standard_normal((b, h * w, c)).astype(np.float32) for h, w in levels]
    poss = [raster_grid(ss, b, "cpu") for ss in levels]
    grid_pos = raster_grid(grid, b, "cpu")
    tables = [pack_neighbor_table(knn(grid_pos, scale_pos(p, ss, grid, no_bias=True), 4), p)
              .numpy() for p, ss in zip(poss, levels)]
    return srcs, embeds, [p.numpy() for p in poss], list(levels) + [grid], tables


def test_encoder_layer_matches_jax():
    """The deformable encoder layer in train mode at dropout 0.2: three
    drops per level (after the attention, inside the FFN, after it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_torch.models.pixel_decoder import MSDeformAttnEncoderLayerPc
    from autofocusformermod_tpu.models.pixel_decoder import (
        MSDeformAttnEncoderLayerPc as JaxLayer)

    srcs, embeds, poss, shapes, tables = _encoder_inputs()
    n = len(srcs)

    def call(xs, consts, det):
        p, t = consts
        if det is None:
            return (xs[:n], [torch.from_numpy(a) for a in p], shapes, xs[n:],
                    [torch.from_numpy(a) for a in t])
        return (list(xs[:n]), [jnp.asarray(a) for a in p], shapes, list(xs[n:]),
                [jnp.asarray(a) for a in t], det)

    store = _unit(JaxLayer(16, 32, 0.2, 3, 2, 2, 1.5, True),
                  MSDeformAttnEncoderLayerPc(16, 32, 3, 2, 2, 1.5, True, dropout=0.2),
                  ("head", "pixel_decoder", "encoder_layer_0"),
                  "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.",
                  srcs + embeds, call, (poss, tables))
    assert len(store) == 9


@pytest.mark.parametrize("attention", ["local", "global"])
def test_aff_block_matches_jax_gather_path(attention):
    """An AFF block (use_pallas=False: JAX's gather path) with DROP_RATE 0.2
    and ATTN_DROP_RATE 0.3: the attention probabilities are dropped with the
    blank sink's column, before it is split off; 64 tokens in clusters of 8,
    two neighbour clusters (or global attention)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_torch.geometry.cluster import nbhd_from_cluster_ids
    from autofocusformermod_torch.geometry.knn import knn
    from autofocusformermod_torch.models.aff import ClusterTransformerBlock
    from autofocusformermod_torch.models.layers import rel_pos_features
    from autofocusformermod_torch.models.pixel_decoder import raster_grid
    from autofocusformermod_tpu.models.aff import ClusterTransformerBlock as JaxBlock

    b, n, c = 2, 64, 8
    pos = raster_grid((8, 8), b, "cpu")
    if attention == "global":
        rel5 = rel_pos_features(pos[:, None, :, :] - pos[:, :, None, :])
        ctx, jctx = {"global": True, "rel_feat5": rel5}, {"fused": False,
                                                          "rel_feat5": jnp.asarray(rel5.numpy())}
    else:
        nc = knn(pos, pos.reshape(b, 8, 8, 2).mean(2), 2)
        member, mask, rel5 = nbhd_from_cluster_ids(pos, nc, 8, n)
        assert mask is None
        ctx = {"global": False, "pos": pos, "nc": nc, "span": 8}
        jctx = {"fused": False, "member_idx": jnp.asarray(member.numpy()), "cluster_mask": None,
                "rel_feat5": jnp.asarray(rel5.numpy())}
    x = np.random.default_rng(2).standard_normal((b, n, c)).astype(np.float32)
    store = _unit(JaxBlock(c, 2, 2.0, drop=0.2, attn_drop=0.3, use_pallas=False),
                  ClusterTransformerBlock(c, 2, 2.0, drop=0.2, attn_drop=0.3),
                  ("backbone", "layers_0", "blocks_0"), "backbone.layers.0.blocks.0.", [x],
                  lambda xs, _, det: (xs[0], ctx) if det is None else (
                      xs[0], jctx, attention == "global", det))
    probs = store["attn/Dropout_0"][0]
    assert probs.shape == (b, 2, n, (n if attention == "global" else 16) + 1)


def test_mixres_vit_block_matches_jax():
    """A MixRes ViT block with DROP_RATE 0.3: the depthwise-conv
    feed-forward's two drops (the ViT attention has none, as in JAX)."""
    pytest.importorskip("jax")
    from autofocusformermod_torch.models.mixres import ViTBlock
    from autofocusformermod_tpu.models.mixres import ViTBlock as JaxBlock

    x = np.random.default_rng(4).standard_normal((2, 16, 8)).astype(np.float32)
    store = _unit(JaxBlock(8, 2, 16, drop=0.3), ViTBlock(8, 2, 16, drop=0.3),
                  ("mask_predictors_0", "backbone", "blocks_0"),
                  "mask_predictors.0.backbone.blocks.0.", [x],
                  lambda xs, _, det: (xs[0], 4, 4) if det is None else (xs[0], 4, 4, det))
    assert sorted(store) == ["mlp/Dropout_0", "mlp/Dropout_1"]


# ---------------------------------------------------------- the whole step
STEP_CASES = {"flagship": {"MASK_FORMER.DROPOUT": 0.1},
              "aff_rates": {"MASK_FORMER.DROPOUT": 0.1, "AFF.DROP_RATE": 0.1,
                            "AFF.ATTN_DROP_RATE": 0.1}}


def step_cfg(case):
    from test_torch_train import train_cfg

    cfg = train_cfg()
    for field, value in STEP_CASES[case].items():
        node, leaf = field.split(".")
        setattr(getattr(cfg.MODEL, node), leaf, value)
    return cfg


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_ref(request):
    """JAX ``make_train_step`` of the tiny flagship (``test_torch_train``'s
    model, its seeded weights carried by the JAX package's converter) at the
    case's rates: the loss terms, every gradient (an optax transform that
    keeps them), the criterion's draws and every Dropout mask."""
    pytest.importorskip("jax")
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from autofocusformermod_torch.models.maskformer import (init_random_weights,
                                                            maskformer_from_config)
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.losses import criterion as jc
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from autofocusformermod_tpu.parallel.train_step import TrainState, make_train_step
    from test_torch_mrml import fast_jit, grads_only
    from test_torch_train import B, NC, P, T, _flax_tree, jax_criterion_draws, semantic_batch

    cfg = step_cfg(request.param)
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    flat_p, flat_s = convert_reference_state_dict(sd)
    batch = semantic_batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_maskformer(cfg)
    mf = cfg.MODEL.MASK_FORMER
    step = make_train_step(jmodel, NC, eos_coef=mf.NO_OBJECT_WEIGHT,
                           class_weight=mf.CLASS_WEIGHT, mask_weight=mf.MASK_WEIGHT,
                           dice_weight=mf.DICE_WEIGHT, num_points=P, donate=False)
    state = TrainState.create(_flax_tree(flat_p), _flax_tree(flat_s), grads_only())
    key = jax.random.PRNGKey(5)
    masks = {}
    orig = jc.NN_RANK_UNCERTAINTY
    jc.NN_RANK_UNCERTAINTY = False
    try:
        with fnn.intercept_methods(jax_masks(masks)):
            new_state, metrics = fast_jit(step, state, jbatch, key)(state, jbatch, key)
        jax.effects_barrier()
    finally:
        jc.NN_RANK_UNCERTAINTY = orig
    _, k_crit = jax.random.split(key)
    return {"case": request.param, "cfg": cfg, "sd": sd, "batch": batch, "masks": masks,
            "draws": jax_criterion_draws(k_crit, mf.DEC_LAYERS, B, T, P),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state)}


def test_flagship_step_with_dropout_matches_jax(step_ref):
    """One training step through the port on JAX's draws and Dropout masks:
    every loss term (rtol 1e-4) and every parameter's gradient (rtol 1e-3,
    atol 1e-4 of its largest entry + 1e-5: ``test_torch_train``'s
    tolerances); each encoder layer drops at 0.1 (9 masks a layer), and
    with the AFF rates every block drops too."""
    from autofocusformermod_torch.engine.train_step import TrainStep
    from autofocusformermod_torch.losses import criterion as tcrit
    from autofocusformermod_torch.models.maskformer import maskformer_from_config
    from test_torch_sampler import Replay
    from test_torch_train import LOSS_TOL

    ref = step_ref
    model = maskformer_from_config(ref["cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref["sd"].items()})
    step = TrainStep(model, ref["cfg"])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    n_enc = ref["cfg"].MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    assert sum(p.startswith("head/pixel_decoder") for p in ref["masks"]) == 9 * n_enc
    assert any(p.startswith("backbone") for p in ref["masks"]) == (ref["case"] == "aff_rates")
    orig = tcrit.NN_RANK_UNCERTAINTY
    tcrit.NN_RANK_UNCERTAINTY = False
    try:
        with replay_masks(model, ref["masks"]):
            total, losses, _ = step.loss_and_grads(batch, Replay(ref["draws"]))
    finally:
        tcrit.NN_RANK_UNCERTAINTY = orig
    np.testing.assert_allclose(total.item(), ref["metrics"]["total_loss"], **LOSS_TOL)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), ref["metrics"][k], err_msg=k, **LOSS_TOL)
    assert len(losses) == 3 * ref["cfg"].MODEL.MASK_FORMER.DEC_LAYERS
    for name, p in model.named_parameters():
        want = ref["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=1e-4 * scale + 1e-5,
                                   err_msg=name)


def test_two_rank_dropout_step_equals_the_one_process_step(tmp_path):
    """MASK_FORMER.DROPOUT 0.1 and the AFF rates at 0.1: two gloo ranks (one
    image each) draw the global batch's masks and keep their rows, so two
    steps equal one process's on the global batch (``test_torch_dist_step``'s
    tolerances)."""
    import torch_dist_workers as W
    from autofocusformermod_torch.config import CfgNode
    from autofocusformermod_torch.models.maskformer import (init_random_weights,
                                                            maskformer_from_config)
    from test_torch_dist_step import check_same_run
    from test_torch_train import semantic_batch

    cfg = CfgNode(step_cfg("aff_rates"))
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    batch = semantic_batch(np.random.default_rng(0))
    one = W.step_worker(cfg, sd, batch, None, steps=2)
    ranks = W.run_ranks(W.step_worker, 2, tmp_path, cfg, sd, batch, None, None, 2)
    check_same_run(one, ranks, 2, cfg.SOLVER.BASE_LR, sd)


def test_attention_dropout_refused_on_the_kernel_path(monkeypatch):
    """In train mode at ATTN_DROP_RATE > 0 a local attention that would
    launch K1 raises (JAX's Pallas path drops no probabilities); in eval
    mode, or at rate 0, it launches as before."""
    from autofocusformermod_torch.models import aff
    from autofocusformermod_torch.models.aff import ClusterAttention

    launched = []

    def fake_kernel(q, *args, **kwargs):
        launched.append(q.shape)
        return q.float(), q[..., :1].float()

    monkeypatch.setattr(aff, "use_kernel", lambda *t: True)
    monkeypatch.setattr(aff, "sfc_cluster_attention", fake_kernel)
    pos = torch.arange(32, dtype=torch.float32).reshape(1, 16, 2)
    ctx = {"global": False, "pos": pos, "nc": torch.zeros(1, 16, 1, dtype=torch.int32),
           "span": 16}
    x = torch.randn(1, 16, 8)
    with pytest.raises(NotImplementedError, match="ATTN_DROP_RATE"):
        ClusterAttention(8, 2, attn_drop=0.1).train()(x, ctx)
    ClusterAttention(8, 2, attn_drop=0.1).eval()(x, ctx)
    ClusterAttention(8, 2, attn_drop=0.0).train()(x, ctx)
    assert len(launched) == 2
