"""The published yamls of the OracleTeacher cascade and of the MRML family
built by the port: ``build_model`` on the JAX-merged yaml has the parameter
count of ``jax.eval_shape(model.init)`` (build and trace only, no
weights).  The JAX models are built as ``test_torch_mrml.jax_model`` builds
them (a MaskFormerML's backbone is the one the JAX registry gives its
MODEL.BACKBONE.NAME), and the plain decoder over an MRML backbone traces
with ``test_torch_mrml.sparse_point2img``; one case holds JAX's own,
unpatched entry point for a Neighbour yaml against the port.  Each trace
takes ~5 s, so these cases have a file of their own.
"""

import numpy as np
import pytest

from autofocusformermod_torch.models.registry import build_model, size_divisibility

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_mrml import jax_model, sparse_point2img  # noqa: F401 (a fixture)

ADE = "configs/ade20k/semantic-segmentation/"
BUILDS = {"maskfiner_oracle_teacher": ADE + "maskfiner/maskfiner_oracle_teacher_bs32_80k.yaml",
          "mrml_mini": ADE + "mixres-metaloss/maskformer2_mrml_mini_bs32_80k.yaml",
          "mrml_ps": ADE + "mixres-metaloss/maskformer2_mrml_ps_bs32_80k.yaml",
          "mrmlnb_large": ADE + "mixres-metaloss-nb/maskformer2_mrmlnb_large_bs32_80k.yaml",
          "mrmean_mini": ADE + "mixres-activation/maskformer2_mrmean_mini_bs32_80k.yaml",
          "maskformer2_ml_R50": ADE + "maskformer2_ml_R50_bs16_160k.yaml",
          "maskformer2_ml_ade20k": "configs/maskformer2_ml_ade20k.yaml"}
ARCH = {"maskfiner_oracle_teacher": "MaskFinerOracleTeacher", "mrmean_mini": "MaskFormer"}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_published_yaml_builds_with_jax_parameter_count(name, sparse_point2img):
    """The parameter count at 128x128.  The bare ``maskformer2_ml_R50`` yaml
    gets the MRML defaults (width 32 with 3 heads, which no attention can
    reshape): the JAX count is taken at one head per scale, which the
    global blocks' parameters do not depend on.  The OracleTeacher yaml's
    stages 0-2 hold the projection decoder (no parameters at width 256)
    and a score MLP, no mask decoder."""
    pytest.importorskip("yaml")
    import jax
    import jax.numpy as jnp

    from test_torch_updown import _merged

    cfg = _merged(BUILDS[name])
    model = build_model(cfg)
    jcfg = _merged(BUILDS[name])
    if name == "maskformer2_ml_R50":
        assert list(jcfg.MODEL.MRML.NUM_HEADS) == [3, 6, 12, 24]
        jcfg.MODEL.MRML.NUM_HEADS = [1, 1, 1, 1]
    jmodel = jax_model(jcfg)
    x = jnp.zeros((1, 128, 128, 3))
    if name == "maskfiner_oracle_teacher":
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "oracle": jax.random.PRNGKey(1)}, x,
            jnp.zeros((1, 128, 128), jnp.int32)))
        assert [p.mask_decoder is None for p in model.mask_predictors] == [True] * 3 + [False]
        assert all(sum(q.numel() for q in p.pixel_decoder.parameters()) == 0
                   for p in model.mask_predictors[:3])
    else:
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert type(model).__name__ == ARCH.get(name, "MaskFormerML")
    assert size_divisibility(cfg) == 32


def test_jax_entry_point_builds_the_global_backbone_for_a_neighbour_yaml():
    """JAX's own ``maskformer_ml_from_config``, unpatched, builds the global
    MixResMetaLoss for ``mrmlnb_mini``'s MixResMetaLossNeighbour yaml: its
    parameter count is the port's build of that yaml with
    MODEL.BACKBONE.NAME MixResMetaLoss, and the port's build of the yaml as
    it stands (the Neighbour backbone it names) has the cluster attention's
    parameters on top."""
    pytest.importorskip("yaml")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    from test_torch_updown import _merged

    path = ADE + "mixres-metaloss-nb/maskformer2_mrmlnb_mini_bs32_80k.yaml"
    jmodel = META_ARCH_REGISTRY.get("MaskFormerML")(_merged(path))
    assert not jmodel.backbone.use_cluster_attention
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    named = _merged(path)
    assert named.MODEL.BACKBONE.NAME == "MixResMetaLossNeighbour"
    neighbour = build_model(named)
    named.MODEL.BACKBONE.NAME = "MixResMetaLoss"
    plain = build_model(named)
    count = {k: sum(p.numel() for p in m.parameters())
             for k, m in (("neighbour", neighbour), ("global", plain))}
    assert count["global"] == jax_count
    # per block a blank key and value (the block's width each) and the
    # relative position's projection onto the heads (5 inputs and a bias):
    # 9728 + 1824 parameters over the 32 blocks
    m = named.MODEL.MRML
    assert count["neighbour"] - count["global"] == sum(
        d * (2 * c + 6 * h) for d, c, h in zip(m.DEPTHS, m.EMBED_DIM, m.NUM_HEADS)) == 11552


def test_updown_tiny_coco_panoptic_preset_has_jax_parameter_count():
    """The ``maskfiner_updown_tiny_coco_panoptic`` preset builds (past the
    cascade's refusals) with the parameter count of JAX's build of the
    merged published yaml, both in bf16 compute (SOLVER.AMP.ENABLED)."""
    pytest.importorskip("yaml")
    import jax
    import jax.numpy as jnp
    import torch

    from autofocusformermod_torch.config import PRESETS
    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    from test_torch_updown import _merged

    model = build_model(PRESETS["maskfiner_updown_tiny_coco_panoptic"]())
    assert type(model).__name__ == "MaskFinerOracleTeacherBB"
    assert model.compute_dtype == torch.bfloat16
    jcfg = _merged("configs/coco/panoptic-segmentation/maskfiner/"
                   "maskfiner_updown_tiny_bs16_50ep.yaml")
    jmodel = META_ARCH_REGISTRY.get(jcfg.MODEL.META_ARCHITECTURE)(jcfg)
    assert jmodel.compute_dtype == jnp.bfloat16
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "oracle": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 128, 128), jnp.int32)))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
