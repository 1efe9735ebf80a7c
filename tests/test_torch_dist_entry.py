"""The PyTorch port's entry points (``graft_entry``) and its (data x model) mesh:
``graft_entry`` against the JAX package's ``__graft_entry__`` (the flagship
config and the dry run's config field by field; ``entry()``'s forward against the JAX model's at a
small image, the port's seeded weights carried over), ``dryrun_multichip``
at 2 and 4 gloo processes, a (2 x 2) step against the two-rank data-parallel
step, and ``tp_leaf_spec`` against JAX's placement for every leaf of the
dry run's model.
"""

import numpy as np
import pytest
import torch

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
import torch_dist_workers as W
from autofocusformermod_torch import graft_entry
from autofocusformermod_torch.parallel import mesh

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_torch_model.py's


def _flat(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _flax_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def test_flagship_cfg_equals_jax_field_by_field():
    pytest.importorskip("jax")
    import __graft_entry__ as jax_entry

    want = dict(_flat(jax_entry._flagship_cfg()))
    got = dict(_flat(graft_entry._flagship_cfg()))
    assert set(got) == set(want)
    differ = {k: (got[k], want[k]) for k in want
              if k != "MODEL.DEVICE" and (got[k] != want[k] or type(got[k]) is not type(want[k]))}
    assert not differ, differ
    assert got["MODEL.AFF.EMBED_DIM"] == [32, 128, 256, 384]


def test_dryrun_cfg_equals_jax_field_by_field(monkeypatch):
    """``dryrun_cfg()`` against the config JAX's dry run builds its model
    from (caught at ``maskformer_from_config`` inside ``dryrun_multichip``,
    on one CPU device): every field equal, MASK_FORMER.DROPOUT the default
    0.1 in both, but TRAIN_NUM_POINTS, which JAX passes to
    ``make_train_step`` (64) instead of setting it."""
    pytest.importorskip("jax")
    import jax

    import __graft_entry__ as jax_entry
    import autofocusformermod_tpu.models as jax_models

    class Caught(Exception):
        pass

    seen = []

    def catch(cfg):
        seen.append(cfg)
        raise Caught

    monkeypatch.setattr(jax_models, "maskformer_from_config", catch)
    with pytest.raises(Caught):
        jax_entry._dryrun_multichip_impl(1, jax.devices("cpu"))
    want = dict(_flat(seen[0]))
    got = dict(_flat(graft_entry.dryrun_cfg()))
    assert set(got) == set(want)
    assert got["MODEL.MASK_FORMER.TRAIN_NUM_POINTS"] == 64
    differ = {k: (got[k], want[k]) for k in want
              if k not in ("MODEL.DEVICE", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS")
              and (got[k] != want[k] or type(got[k]) is not type(want[k]))}
    assert not differ, differ
    assert got["MODEL.MASK_FORMER.DROPOUT"] == 0.1


def test_entry_forward_matches_jax_at_a_small_image():
    """``entry(device="cpu")``: the callable and JAX's example shapes; the
    flagship's forward at 128x128 from the port's seeded weights against the
    JAX model's on the same weights (carried by the JAX package's
    converter)."""
    pytest.importorskip("jax")
    import __graft_entry__ as jax_entry
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer

    fn, (model, x) = graft_entry.entry(device="cpu")
    assert tuple(x.shape) == (1, 512, 512, 3) and x.dtype == torch.float32
    assert not model.training and next(model.parameters()).device.type == "cpu"
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).uniform(0, 255, (1, 512, 512, 3)).astype(np.float32))
    small = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (1, 128, 128, 3))
                             .astype(np.float32))
    logits, masks = fn(model, small)
    assert tuple(logits.shape) == (1, 100, 151) and tuple(masks.shape) == (1, 100, 32, 32)

    flat_p, flat_s = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    variables = {"params": _flax_tree(flat_p), "batch_stats": _flax_tree(flat_s)}
    jmodel = jax_maskformer(jax_entry._flagship_cfg())
    # jitted once (~20 s on one core; op by op ~110 s)
    out = jax.jit(lambda v, img: jmodel.apply(v, img, train=False))(
        variables, jnp.asarray(small.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(out["pred_logits"]), **TOL)
    np.testing.assert_allclose(masks.numpy(), np.asarray(out["pred_masks"]), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, tmp_path, capfd):
    """Two steps, the first matched by scipy on the host and the second by
    the default solver, as JAX's dry run switches to its "jv" backend for
    its second step (each rank asserts that its step's solver alone ran)."""
    from autofocusformermod_torch.losses import matcher

    graft_entry.dryrun_multichip(n, dist_url=f"file://{tmp_path / 'rendezvous'}")
    n_data, n_model = graft_entry.dryrun_mesh(n)
    assert (n_data, n_model) == ((2, 1) if n == 2 else (2, 2))
    out = capfd.readouterr().out
    assert f"dryrun_multichip({n}) OK: {n_data} x {n_model} mesh" in out
    assert "(scipy) second step loss=" in out and out.rstrip().endswith("(jv)")
    assert matcher._MATCHER_BACKEND is None


@pytest.fixture(scope="module")
def dryrun_model():
    from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

    cfg = graft_entry.dryrun_cfg()
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    return cfg, model


def test_2x2_mesh_steps_equal_the_data_parallel_steps(dryrun_model, tmp_path):
    """Two steps on a (2 x 2) mesh (the matrices and their AdamW moments
    sharded over ``model``) equal two steps of two data ranks on the same
    global batch of 2: metrics (the sharded global norm among them) and the
    gathered parameters; between steps a rank holds half of each sharded
    matrix and of its moments."""
    cfg, model = dryrun_model
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    batch = graft_entry.dryrun_batch(2)
    dp = W.run_ranks(W.tp_step_worker, 2, tmp_path, cfg, sd, batch, 1)
    tp = W.run_ranks(W.tp_step_worker, 4, tmp_path, cfg, sd, batch, 2)
    sharded = {n for n, p in model.named_parameters()
               if mesh.tp_leaf_spec(p, 2, *_owner(model, n))}
    assert len(sharded) > 10
    for got in tp:
        for i, (m, want) in enumerate(zip(got["metrics"], dp[0]["metrics"])):
            for k, v in want.items():
                np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-6, err_msg=f"{i} {k}")
        for name, p in dp[0]["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        for name, shape in got["held"].items():
            full = tuple(dp[0]["held"][name])
            assert (shape != full) == (name in sharded), (name, shape, full)
            assert got["moments"][name] == shape, name
            if name in sharded:
                assert np.prod(shape) * 2 == np.prod(full), (name, shape, full)


def _owner(model, name):
    mod_name, leaf = name.rsplit(".", 1)
    return model.get_submodule(mod_name), leaf


def test_tp_leaf_spec_gives_jax_placement_for_every_leaf(dryrun_model):
    """JAX's ``tp_leaf_spec`` on every leaf of the dry run's flax parameter
    tree (``jax.eval_shape`` of its init) against the port's on the tensor
    that leaf lands on: the same leaves sharded, over the axis that holds
    JAX's last (output-feature) axis -- the port's axis 0 for a Dense or
    Conv kernel (the bridge transposes it there; an attention layer's q, k
    and v land on its one in_proj_weight), the last axis for any other."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as jax_entry

    from autofocusformermod_torch.engine.convert_checkpoint import torch_name
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from autofocusformermod_tpu.parallel.mesh import tp_leaf_spec as jax_spec

    cfg, model = dryrun_model
    # the JAX dry run's config: its flagship with the fields the dry run sets
    jcfg = jax_entry._flagship_cfg(num_classes=7)
    base = dict(_flat(graft_entry._flagship_cfg(num_classes=7)))
    for key, value in _flat(cfg):
        if value != base[key]:
            *path, leaf = key.split(".")
            node = jcfg
            for part in path:
                node = node[part]
            node[leaf] = value
    jmodel = jax_maskformer(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    params = dict(model.named_parameters())
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = tuple(p.key for p in path)
        sharded = jax_spec(leaf, 2) != jax.sharding.PartitionSpec()
        name = torch_name(keys)
        kernel = keys[-1] == "kernel"
        want.setdefault(name, set()).add((sharded, kernel))
    assert set(want) == set(params)
    n_sharded = 0
    for name, p in params.items():
        (sharded, kernel), = want[name]               # q, k and v agree
        spec = mesh.tp_leaf_spec(p, 2, *_owner(model, name))
        if not sharded:
            assert spec == (), name
            continue
        n_sharded += 1
        axis = 0 if kernel else p.dim() - 1
        assert spec == tuple(mesh.MODEL_AXIS if i == axis else None for i in range(p.dim())), (
            name, spec)
    assert n_sharded > 10



def test_replicate_and_shard_batch_over_two_ranks(tmp_path):
    """``replicate`` gives every rank rank 0's parameters and buffers;
    ``shard_batch`` gives rank r rows r*b/W .. (r+1)*b/W of every entry, as
    ``NamedSharding(P("data"))`` lays a batch out."""
    ranks = W.run_ranks(W.replicate_worker, 2, tmp_path)
    torch.manual_seed(100)
    own = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    own[1].running_mean.normal_()
    for r, got in enumerate(ranks):
        for k, v in own.state_dict().items():
            assert torch.equal(got["state"][k], v), (r, k)
        assert torch.equal(got["batch"]["x"], torch.arange(8).reshape(4, 2)[2 * r:2 * r + 2])
        assert got["batch"]["names"] == list("abcd")[2 * r:2 * r + 2]
    assert mesh.shard_batch({"x": [1, 2, 3]}) == {"x": [1, 2, 3]}        # alone: the whole
