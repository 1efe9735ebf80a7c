"""The evaluators of several processes merged into one.

Counterpart of ``autofocusformermod_tpu/evaluation/distributed.py``: each
process scores its shard of a test set (``data/loader.py eval_loader``);
``merge_across_processes`` gathers every process's evaluator (pickled,
``torch.distributed.all_gather_object`` over the data axis) and merges them
in rank order, so ``Trainer.test`` reports the global metrics on every
process.  One process alone: a no-op.
"""

from __future__ import annotations

from torch import distributed as dist

from ..parallel import mesh


def merge_across_processes(evaluator):
    """Merge every data rank's evaluator, in rank order, into ``evaluator``,
    whose state is replaced in place by the merged one.  Returns it."""
    if mesh.axis_size() == 1:
        return evaluator
    gathered = [None] * mesh.axis_size()
    dist.all_gather_object(gathered, evaluator, group=mesh.stats_group())
    merged = gathered[0]
    for other in gathered[1:]:
        merged.merge(other)
    evaluator.__dict__.update(merged.__dict__)
    return evaluator
