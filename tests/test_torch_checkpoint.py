"""The port's reference-checkpoint loader and the train step's target masks,
against the JAX package's functions on the same files and batches.

``engine/convert_checkpoint.py:load_reference_weights`` reads what the JAX
package's ``load_torch_state_dict`` + ``_strip_prefix`` read (the same names,
the same arrays, exactly) and merges it by name into a model, counted; the
files are written by the test.  ``engine/train_step.py:device_masks`` takes a
batch's own ``masks`` first, as ``parallel/train_step.py:_device_masks``.
"""

import pickle

import numpy as np
import pytest
import torch
from torch import nn

from autofocusformermod_torch.engine.convert_checkpoint import (load_reference_weights,
                                                                read_reference_state_dict)
from autofocusformermod_torch.engine.train_step import device_masks


class Toy(nn.Module):
    """A model with the reference's kinds of entries: weights, biases and a
    BatchNorm's statistics (num_batches_tracked is int64)."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Linear(4, 6), nn.BatchNorm1d(6))
        self.head = nn.Linear(6, 3)


def _donor_state():
    torch.manual_seed(1)
    donor = Toy()
    with torch.no_grad():
        donor.backbone[1].running_mean.uniform_()
        donor.backbone[1].num_batches_tracked.fill_(7)
    return donor.state_dict()


def _backbone_only(sd):
    return {k: v for k, v in sd.items() if k.startswith("backbone.")}


# name -> (file suffix, what the file holds, given the donor's state dict)
CASES = {
    "bare": (".pth", lambda sd: sd),
    "model": (".pth", lambda sd: {"model": sd, "iteration": 5}),
    "state_dict_module": (".pth", lambda sd: {"state_dict": {"module." + k: v
                                                             for k, v in sd.items()}}),
    "backbone_only": (".pth", lambda sd: {"model": {"module." + k: v
                                                    for k, v in _backbone_only(sd).items()}}),
    "pkl_numpy": (".pkl", lambda sd: {"model": {k: v.numpy() for k, v in sd.items()},
                                      "__author__": "detectron2"}),
    "wrong_shape": (".pth", lambda sd: {**sd, "head.weight": torch.zeros(3, 5)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_loader_matches_jax_reader_and_merges_by_name(case, tmp_path, capsys):
    from autofocusformermod_tpu.engine.convert_checkpoint import (_strip_prefix,
                                                                  load_torch_state_dict)

    suffix, build = CASES[case]
    donor = _donor_state()
    path = str(tmp_path / f"weights{suffix}")
    if suffix == ".pkl":
        with open(path, "wb") as f:
            pickle.dump(build(donor), f)
    else:
        torch.save(build(donor), path)

    # what the file holds, read by both packages
    want = _strip_prefix(load_torch_state_dict(path))
    got = read_reference_state_dict(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    torch.manual_seed(2)
    model = Toy()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    if case == "wrong_shape":
        with pytest.raises(ValueError, match="shape mismatch at head.weight"):
            load_reference_weights(model, path)
        return
    hits, misses = load_reference_weights(model, path)
    expected = _backbone_only(donor) if case == "backbone_only" else donor
    assert hits == len(expected) and sorted(misses) == sorted(set(before) - set(expected))
    for k, v in model.state_dict().items():
        assert torch.equal(v, expected[k] if k in expected else before[k]), k
    line = f"[convert_checkpoint] loaded {hits}/{len(before)} tensors"
    if misses:
        line += f"; missing e.g. {misses[:5]}"
    assert line in capsys.readouterr().out


def test_reference_loader_notes_a_missing_file(tmp_path, capsys):
    model = Toy()
    assert load_reference_weights(model, str(tmp_path / "aff_mini.pth")) is None
    assert "aff_mini.pth not found; training from scratch" in capsys.readouterr().out


@pytest.mark.parametrize("ships_masks", [True, False])
def test_device_masks_match_jax(ships_masks):
    import jax.numpy as jnp
    from autofocusformermod_tpu.parallel.train_step import _device_masks

    rng = np.random.default_rng(0)
    b, t, h, w = 2, 4, 16, 12
    batch = {"sem_seg_map": rng.integers(0, 5, (b, h, w)).astype(np.uint8),
             "labels": rng.integers(0, 5, (b, t)).astype(np.int32),
             "valid": np.array([[True, True, True, False], [True, False, False, False]])}
    if ships_masks:
        # instance masks that the sem_seg map does not give: overlapping, one empty
        masks = (rng.random((b, t, h, w)) < 0.4).astype(np.uint8)
        masks[0, 1] = 0
        batch["masks"] = masks
    want = np.asarray(_device_masks({k: jnp.asarray(v) for k, v in batch.items()}))
    got = device_masks({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    if ships_masks:
        np.testing.assert_array_equal(got.numpy(), batch["masks"])
