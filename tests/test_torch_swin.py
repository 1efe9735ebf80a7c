"""The PyTorch port's MaskFormerSwin baseline against the JAX package: the
Swin backbone (padding plus shifted windows), ``bilinear_sample``, the grid
deformable attention and pixel decoder, the grid attention mask, the
pre-norm decoder layers, the whole forward, one training step, the weights
bridge, the optimizer's groups and the ``swin_tiny`` and
``swin_base_384_res640`` presets.

A tiny MaskFormerSwin (Swin of width 16, 2 blocks a stage, window 7; a
32-wide grid pixel decoder with one encoder layer; 4 decoder layers, 4
queries) is initialised in JAX at 96x96, so that the stride-4 canvas is 24
wide: the first two stages pad 24 -> 28 and 12 -> 14 and shift (as Swin-B's
window 12 pads every stage at 640x640), the last two pad 6 and 3 to one
window and do not shift.  Its parameters are perturbed with seeded noise,
carried over with ``flax_to_torch_state_dict`` and run on the same uint8
images (batch 2) in fp32 on the CPU; the training step (DropPath off) replays
the JAX criterion's draws.

Tolerances: outputs, features and decoder outputs within 1e-4 of each one's
largest entry; ``bilinear_sample``, the deformable attention, the grid
attention mask and the pre-norm layers 1e-5 absolute on unit-scale inputs;
loss terms rtol 1e-4; gradients rtol 1e-3 and atol 1e-4 of the parameter's
largest gradient plus 1e-5; the update rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.models.layers import DropPath, set_dropout_generator
from autofocusformermod_torch.models.pixel_decoder_grid import MSDeformAttnGrid, bilinear_sample
from autofocusformermod_torch.models.registry import build_model
from autofocusformermod_torch.models.transformer_decoder import (CrossAttentionLayer, FFNLayer,
                                                                 SelfAttentionLayer,
                                                                 grid_attn_mask)

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_resnet import (assert_close_to_scale, check_bridge, check_features,
                               check_gradients, check_loss_terms, check_outputs,
                               check_param_groups, check_preset_matches_yaml, check_update,
                               jax_reference, port_reference, tiny_head)

SIZE = 96
ABS = dict(rtol=0, atol=1e-5)
SWIN_YAML = "configs/ade20k/semantic-segmentation/swin/maskformer2_swin_{}.yaml"


def tiny_swin_cfg():
    from autofocusformermod_tpu.config import add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_maskformer2_config(cfg)
    cfg.MODEL.META_ARCHITECTURE = "MaskFormerSwin"
    cfg.MODEL.BACKBONE.NAME = "D2SwinTransformer"
    s = cfg.MODEL.SWIN
    s.EMBED_DIM, s.DEPTHS, s.NUM_HEADS, s.WINDOW_SIZE = 16, [2, 2, 2, 2], [2, 2, 2, 2], 7
    s.DROP_PATH_RATE = 0.0
    cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM = cfg.MODEL.SEM_SEG_HEAD.MASK_DIM = 32
    cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 32
    cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME = "MultiScaleMaskedTransformerDecoderSwin"
    return tiny_head(cfg)


@pytest.fixture(scope="module")
def ref():
    from autofocusformermod_tpu.models.meta_arch_variants import maskformer_swin_from_config

    return jax_reference(tiny_swin_cfg(), maskformer_swin_from_config, SIZE)


@pytest.fixture(scope="module")
def port(ref):
    return port_reference(ref)


def _perturbed(variables, seed=1):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])


# ---------------------------------------------------------------- backbone
def test_tiny_swin_pads_and_shifts_the_first_two_stages(ref):
    ws = ref["cfg"].MODEL.SWIN.WINDOW_SIZE
    sides = [SIZE // 4 // 2 ** i for i in range(4)]
    assert sides == [24, 12, 6, 3]
    padded = [s + (ws - s % ws) % ws for s in sides]
    assert padded == [28, 14, 7, 7]
    assert [p > ws for p in padded] == [True, True, False, False]     # the shift stays on


def test_swin_features_match_jax(ref, port):
    """res2..res5 after their norms, their positions (times 2**stage) and
    the stride-4 canvas as every level's spatial shape."""
    check_features(ref, port)
    assert all(port["feats"][f"res{i}_spatial_shape"] == (24, 24) for i in range(2, 6))


def test_swin_drop_path_draws_from_its_generator():
    """Rates rise linearly over the depth to DROP_PATH_RATE; every DropPath
    takes the generator that set_dropout_generator gives, so two models on
    equal generators drop the same branches."""
    cfg = tiny_swin_cfg()
    cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
    model = build_model(cfg)
    rates = [m.rate for m in model.backbone.modules() if isinstance(m, DropPath)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 8), rtol=1e-6)
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3)).astype(np.uint8))
    outs = []
    for _ in range(2):
        torch.manual_seed(0)
        m = build_model(cfg).train()
        set_dropout_generator(m, torch.Generator().manual_seed(7))
        assert all(d.generator is not None for d in m.modules() if isinstance(d, DropPath))
        outs.append(m.backbone(m.normalize(x))["res5"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------- pixel decoder
def test_bilinear_sample_matches_jax_inside_and_outside_the_map():
    """Zero padding: locations up to 0.3 of the map beyond every edge."""
    from autofocusformermod_tpu.models.pixel_decoder_grid import bilinear_sample as jax_sample

    rng = np.random.default_rng(4)
    v = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (2, 200, 2)).astype(np.float32)
    want = np.asarray(jax_sample(v, loc))
    got = bilinear_sample(torch.from_numpy(v), torch.from_numpy(loc)).numpy()
    np.testing.assert_allclose(got, want, **ABS)
    outside = (loc < -0.5 / 9).any(-1) | (loc > 1 + 0.5 / 7).any(-1)
    assert outside.sum() > 20 and np.abs(want[outside]).max() < np.abs(want).max()


def test_msdeform_attn_grid_matches_jax():
    """One deformable attention over three levels (5x7, 3x4, 2x2), JAX's
    offset-bias fan-out plus perturbed weights, reference points jittered
    so samples straddle the edges."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.pixel_decoder_grid import MSDeformAttnGrid as JaxAttn

    rng = np.random.default_rng(5)
    shapes = [(5, 7), (3, 4), (2, 2)]
    c, nq, b = 16, 11, 2
    query = rng.standard_normal((b, nq, c)).astype(np.float32)
    refs = rng.uniform(-0.1, 1.1, (b, nq, 3, 2)).astype(np.float32)
    values = [rng.standard_normal((b, h, w, c)).astype(np.float32) for h, w in shapes]
    jmod = JaxAttn(c, 3, 2, 4)
    variables = jmod.init(jax.random.PRNGKey(0), query, refs, values, shapes)
    params = _perturbed(variables)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(query), jnp.asarray(refs),
                                 [jnp.asarray(v) for v in values], shapes))
    mod = MSDeformAttnGrid(c, 3, 2, 4)
    init = dict(mod.state_dict())
    jinit = flax_to_torch_state_dict(variables["params"])
    torch.testing.assert_close(init["sampling_offsets.bias"], jinit["sampling_offsets.bias"])
    mod.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    got = mod(torch.from_numpy(query), torch.from_numpy(refs),
              [torch.from_numpy(v) for v in values], shapes).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_pixel_decoder_matches_jax(ref, port):
    """Mask features (the FPN's bilinear upsample of res3 to res2), the
    encoder's output and the three levels with their positions and (h, w),
    each package on its own Swin features."""
    want_mf, want_mf_pos, want_t0, want_ms, want_poss, want_shapes = ref["pd"]
    got_mf, got_mf_pos, got_t0, got_ms, got_poss, got_shapes = port["pd"]
    assert_close_to_scale(got_mf.numpy(), want_mf, name="mask_features")
    np.testing.assert_array_equal(got_mf_pos.numpy(), want_mf_pos)
    assert_close_to_scale(got_t0.numpy(), want_t0, name="transformer_out")
    for g, w in zip(got_ms, want_ms):
        assert_close_to_scale(g.numpy(), w, name="multi_scale")
    for g, w in zip(got_poss, want_poss):
        np.testing.assert_array_equal(g.numpy(), w)
    assert [tuple(s) for s in got_shapes] == [(3, 3), (6, 6), (12, 12)]
    assert [tuple(int(v) for v in s) for s in want_shapes] == [(3, 3), (6, 6), (12, 12)]


# ---------------------------------------------------------- mask decoder
@pytest.mark.parametrize("src, dst", [((24, 24), (3, 3)), ((24, 24), (6, 6)),
                                      ((24, 24), (12, 12)), ((40, 24), (5, 7)),
                                      ((128, 128), (20, 20))])
def test_grid_attn_mask_resize_matches_jax_image_resize(src, dst):
    """The Swin decoder's attention mask shrinks the mask logits with
    jax.image.resize's antialiased bilinear: without antialiasing this
    fails (differences up to ~2 on unit-normal logits)."""
    import jax

    rng = np.random.default_rng(6)
    logits = (2 * rng.standard_normal((2, 3, *src))).astype(np.float32)
    want = np.asarray(jax.image.resize(logits, (2, 3, *dst), "bilinear")).reshape(2, 3, -1)
    got = grid_attn_mask(torch.from_numpy(logits), dst).numpy()
    np.testing.assert_allclose(got, want, **ABS)
    np.testing.assert_array_equal(got < 0, want < 0)


@pytest.mark.parametrize("layer", ["self", "cross", "ffn"])
def test_pre_norm_layers_match_jax(layer):
    """The pre-norm branches of the three decoder layers (a masked
    cross-attention with one row fully masked out)."""
    import jax

    from autofocusformermod_tpu.models import transformer_decoder as jtd

    rng = np.random.default_rng(7)
    c, q, n = 16, 5, 9
    tgt = rng.standard_normal((2, q, c)).astype(np.float32)
    qpos = rng.standard_normal((2, q, c)).astype(np.float32)
    mem = rng.standard_normal((2, n, c)).astype(np.float32)
    pos = rng.standard_normal((2, n, c)).astype(np.float32)
    mask = rng.random((2, 2, q, n)) < 0.4
    mask[:, :, 0] = False
    if layer == "self":
        jmod, mod, args = jtd.SelfAttentionLayer(c, 2, pre_norm=True), \
            SelfAttentionLayer(c, 2, pre_norm=True), (tgt, qpos)
    elif layer == "cross":
        jmod, mod, args = jtd.CrossAttentionLayer(c, 2, pre_norm=True), \
            CrossAttentionLayer(c, 2, pre_norm=True), (tgt, mem, mask, pos, qpos)
    else:
        jmod, mod, args = jtd.FFNLayer(c, 24, pre_norm=True), \
            FFNLayer(c, 24, pre_norm=True), (tgt,)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *args))
    want = np.asarray(jmod.apply({"params": params}, *args))
    mod.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    got = mod(*(torch.from_numpy(np.asarray(a)) for a in args)).detach().numpy()
    np.testing.assert_allclose(got, want, **ABS)
    post = type(mod)(*((c, 2) if layer != "ffn" else (c, 24)))
    post.load_state_dict(mod.state_dict())
    assert np.abs(post(*(torch.from_numpy(np.asarray(a)) for a in args)).detach().numpy()
                  - want).max() > 1e-2


# ------------------------------------------------------------- whole model
def test_maskformer_swin_matches_jax(ref, port):
    check_outputs(ref, port)


def test_swin_step_loss_terms_match_jax(ref, port):
    check_loss_terms(ref, port)


def test_swin_step_every_gradient_matches_jax(ref, port):
    check_gradients(ref, port)
    assert port["grads"]["backbone.layers.0.blocks.1.attn.relative_position_bias_table"] \
        .abs().max() > 0


def test_swin_step_update_matches_optax(ref, port):
    check_update(ref, port)


def test_swin_bridge_covers_every_leaf_and_tensor(ref):
    check_bridge(ref)
    sd = build_model(ref["cfg"]).state_dict()
    assert {"backbone.patch_embed.proj.weight", "backbone.layers.0.blocks.1.attn.qkv.weight",
            "backbone.layers.2.downsample.reduction.weight", "backbone.norm3.weight",
            "sem_seg_head.pixel_decoder.input_proj.2.1.weight",
            "sem_seg_head.pixel_decoder.adapter_1.norm.weight",
            "sem_seg_head.pixel_decoder.layer_1.bias",
            "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.value_proj.weight",
            "sem_seg_head.pixel_decoder.mask_features.weight"} <= set(sd)


def test_swin_param_groups_match_make_label_fn(ref):
    got = check_param_groups(ref)
    assert got["backbone.layers.1.blocks.0.attn.relative_position_bias_table"] == "backbone_norm"
    assert got["sem_seg_head.pixel_decoder.adapter_1.norm.weight"] == "norm"


# ------------------------------------------------------------------ presets
@pytest.mark.parametrize("preset, yaml, embed, window, size", [
    ("swin_tiny", "tiny_bs16_160k", 96, 7, 512),
    ("swin_base_384_res640", "base_384_bs16_160k_res640", 128, 12, 640)])
def test_swin_presets_match_yaml(preset, yaml, embed, window, size):
    seen = check_preset_matches_yaml(preset, SWIN_YAML.format(yaml))
    assert {"MODEL.META_ARCHITECTURE", "MODEL.SWIN.EMBED_DIM", "MODEL.SWIN.DEPTHS",
            "MODEL.SWIN.NUM_HEADS", "MODEL.SWIN.WINDOW_SIZE", "MODEL.SWIN.DROP_PATH_RATE",
            "MODEL.SWIN.MLP_RATIO", "MODEL.SWIN.PATCH_SIZE", "INPUT.CROP.SIZE",
            "INPUT.SIZE_DIVISIBILITY", "INPUT.MIN_SIZE_TEST", "INPUT.MAX_SIZE_TEST",
            "TEST.AUG.MIN_SIZES", "TEST.AUG.MAX_SIZE", "SOLVER.IMS_PER_BATCH",
            "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME"} <= seen
    cfg = PRESETS[preset]()
    assert (cfg.MODEL.SWIN.EMBED_DIM, cfg.MODEL.SWIN.WINDOW_SIZE) == (embed, window)
    assert tuple(cfg.INPUT.CROP.SIZE) == (size, size) and cfg.INPUT.MAX_SIZE_TEST == 4 * size


def test_swin_base_preset_builds_and_crops_at_640():
    """The Trainer's training mapper crops 640x640; the model (built on the
    meta device: shapes only) has Swin-B's depths and heads."""
    from types import SimpleNamespace

    from autofocusformermod_torch.engine.train import Trainer

    cfg = PRESETS["swin_base_384_res640"]()
    mapper = Trainer.build_mapper(SimpleNamespace(cfg=cfg), is_train=True)
    assert mapper.crop_size == (640, 640) and mapper.size_divisibility == 640
    with torch.device("meta"):
        swin = build_model(cfg).backbone
    assert [len(layer.blocks) for layer in swin.layers] == [2, 2, 18, 2]
    assert swin.layers[3].blocks[0].attn.num_heads == 32
    assert cfg.TEST.AUG.MIN_SIZES[-1] == 1120 and cfg.TEST.AUG.MAX_SIZE == 4480


def test_train_net_trains_swin_tiny_one_step(tmp_path):
    """``train_net --config swin_tiny`` takes one step on the CPU at 128x128
    (batch 1, 1024 points): 3 finite loss terms for each of its 10 outputs."""
    import json

    from autofocusformermod_torch import train_net

    train_net.main(["--config", "swin_tiny", "--device", "cpu", "--synthetic", "--max-iter", "1",
                    "INPUT.CROP.SIZE", "[128, 128]", "SOLVER.IMS_PER_BATCH", "1",
                    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "1024", "OUTPUT_DIR", str(tmp_path)])
    metrics = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    terms = {k: v for k, v in metrics[0].items() if k.startswith("loss_")}
    assert len(terms) == 3 * 10 and all(np.isfinite(v) for v in terms.values())
