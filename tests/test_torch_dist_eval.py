"""The PyTorch port's evaluation and command line over several processes:
``merge_across_processes`` (a no-op alone; at two ranks the JAX
evaluators' metrics over all samples), ``Trainer.test()`` at two ranks
against one, and ``train_net --device cpu --num-gpus 2`` (training,
checkpoints and metric files from rank 0 alone, resume on both ranks, the
refusal of more GPUs than the machine has).  Ranks are gloo processes on
the CPU (``tests/torch_dist_workers.py``); the JAX references are computed
in this process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
import torch_dist_workers as W
from autofocusformermod_torch.evaluation import SemSegEvaluator
from autofocusformermod_torch.evaluation.distributed import merge_across_processes

REPO = Path(__file__).resolve().parents[1]
METRIC_ATOL = 1e-9


def test_merge_across_processes_single_is_noop():
    ev = SemSegEvaluator(2)
    ev.process(np.zeros((2, 2), int), np.zeros((2, 2), int))
    conf = ev._conf.copy()
    assert merge_across_processes(ev) is ev
    np.testing.assert_array_equal(ev._conf, conf)


def _sem_seg_samples(n=6, nc=5, hw=(24, 32), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, nc, hw)
        gt[rng.random(hw) < 0.1] = 255
        pred = np.where(rng.random(hw) < 0.7, np.clip(gt, 0, nc - 1), rng.integers(0, nc, hw))
        out.append((pred, gt))
    return out


@pytest.mark.parametrize("kind", ["sem_seg", "panoptic"])
def test_merge_across_two_ranks_gives_jax_metrics_over_all_samples(kind, tmp_path):
    pytest.importorskip("jax")
    from autofocusformermod_tpu.evaluation import PanopticEvaluator as JaxPan
    from autofocusformermod_tpu.evaluation import SemSegEvaluator as JaxSem

    if kind == "sem_seg":
        nc, things = 5, ()
        samples = _sem_seg_samples()
        ref = JaxSem(nc)
    else:
        from test_torch_panoptic import _panoptic_pairs

        nc, things = 6, (0, 1, 2)
        samples = list(_panoptic_pairs(3, n=6))
        ref = JaxPan(set(things), nc)
    for s in samples:
        ref.process(*s)
    want = ref.evaluate()
    ranks = W.run_ranks(W.merge_worker, 2, tmp_path, kind, samples, nc, things)
    for got in ranks:
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= METRIC_ATOL, (k, got[k], v)
    key = "mIoU" if kind == "sem_seg" else "PQ"
    assert 0 < want[key] < 100


# ------------------------------------------------------------- Trainer.test()
def _tiny_trainer_cfg(out, *extra):
    from test_torch_trainer import TINY

    from autofocusformermod_torch.config import aff_mini_cfg

    cfg = aff_mini_cfg()
    cfg.merge_from_list(TINY + ["OUTPUT_DIR", str(out)] + list(extra))
    return cfg


def _semantic_sets(root):
    """A tiny registered test set of five images (so that the two ranks'
    shards differ in size): [(name, image root, label root, classes)] and
    the overrides that evaluate it."""
    from test_torch_data import write_pairs

    imgs, gts = write_pairs(Path(root) / "val", [(128, 192), (100, 180), (140, 140), (96, 128),
                                                 (128, 160)], seed=4, classes=(0, 6))
    sets = [("dist_val", imgs, gts, [f"c{i}" for i in range(6)])]
    return sets, ["DATASETS.TEST", "('dist_val',)", "INPUT.MIN_SIZE_TEST", "128",
                  "INPUT.MAX_SIZE_TEST", "256", "INPUT.SIZE_DIVISIBILITY", "128"]


def test_trainer_test_at_two_ranks_equals_one_rank(tmp_path):
    from autofocusformermod_torch.models.registry import build_model

    sets, opts = _semantic_sets(tmp_path / "data")
    cfg = _tiny_trainer_cfg(tmp_path / "out", *opts)
    torch.manual_seed(0)
    sd = {k: v.numpy().copy() for k, v in build_model(cfg).state_dict().items()}
    one = W.trainer_test_worker(cfg, sets, sd)
    ranks = W.run_ranks(W.trainer_test_worker, 2, tmp_path, cfg, sets, sd)
    assert set(one) == {"dist_val"} and 0 <= one["dist_val"]["mIoU"] <= 100
    for got in ranks:
        assert got == one


# ------------------------------------------------------------------ train_net
def _cli(out):
    from test_torch_trainer import TINY

    return ["--config", "aff_mini", "--synthetic", "--device", "cpu"] + TINY + [
        "OUTPUT_DIR", str(out)]


def test_train_net_two_processes_checkpoint_from_rank_0_and_resume(tmp_path):
    """``--num-gpus 2 --device cpu`` trains one step in two gloo processes;
    rank 0 alone writes the checkpoint and ``metrics.jsonl`` (one line a
    step, no second writer's files); ``--resume`` restores on both ranks,
    which continue with one model."""
    out = tmp_path / "out"
    cli = _cli(out)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "autofocusformermod_torch.train_net", *cli[:5], "--num-gpus", "2",
         "--max-iter", "1", "--dist-url", f"file://{tmp_path / 'rendezvous'}", *cli[5:]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000001.pt"]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1]
    assert np.isfinite(json.loads(lines[0])["total_loss"])
    assert proc.stdout.count("[step") <= 1
    # resumed in a group of two: both ranks restore step 1 (the AdamW moments
    # too: each rank's optimizer has taken two steps) and train step 2
    ranks = W.run_ranks(W.train_net_worker, 2, tmp_path,
                        cli[:5] + ["--resume", "--max-iter", "2"] + cli[5:])
    for got in ranks:
        assert got["start_step"] == 2 and got["adam_steps"] == {2}
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000001.pt", "step_00000002.pt"]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]


def test_train_net_refuses_more_gpus_than_the_machine_has(monkeypatch, tmp_path):
    from autofocusformermod_torch import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="asks for 2 GPUs; this machine has 1"):
        train_net.main(["--config", "aff_mini", "--synthetic", "--num-gpus", "2",
                        "OUTPUT_DIR", str(tmp_path)])
