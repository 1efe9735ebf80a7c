"""evaluation of the PyTorch port (see the package docstring)."""

from .instance_evaluation import (CityscapesInstanceEvaluator, InstanceSegEvaluator,
                                  LVISInstanceSegEvaluator)
from .panoptic_evaluation import PanopticEvaluator
from .sem_seg_evaluation import SemSegEvaluator

__all__ = ["SemSegEvaluator", "PanopticEvaluator", "InstanceSegEvaluator",
           "CityscapesInstanceEvaluator", "LVISInstanceSegEvaluator"]
