"""Trainer: config -> model, optimizer and training step on one device; the
train loop with checkpoints, resume, the NaN watchdog, metric logging and
evaluation every TEST.EVAL_PERIOD steps; and the semantic, panoptic and
instance evaluation.

Counterpart of ``autofocusformermod_tpu/engine/train.py``.  ``train()``
reads DATASETS.TRAIN through the mapper INPUT.DATASET_MAPPER_NAME names
(semantic, panoptic, instance, or one of the COCO LSJ mappers) and
``TrainLoader`` unless the caller passes batches
(``data.synthetic.synthetic_batches`` where no dataset is installed);
``test()`` scores each of DATASETS.TEST by its metadata's evaluator_type:
semantic (mIoU), panoptic (PQ) or instance (COCO, Cityscapes or LVIS mask
AP), one evaluator per dataset.  Every meta-architecture of
``models/registry.py`` (MaskFormer, MaskFormerSwin, the MaskFiner cascade
and the OracleTeacher-BB cascades) trains and evaluates.

Randomness: the weights are initialised under cfg.SEED, and generators on
the device -- the criterion's (cfg.SEED + 1), DropPath's (cfg.SEED + 2)
and, for the OracleTeacher cascades, the teacher's (cfg.SEED + 3) -- carry
the run's streams.  A checkpoint holds their states with the
model's (parameters and BatchNorm statistics), the optimizer's and the
schedule's, so a resumed run continues the stream the interrupted one left.
The data loader's order is not in the checkpoint: a resumed run reads other
samples than the uninterrupted one would have.

Several processes (``parallel/mesh.py``: ``train_net --num-gpus N`` or
``torchrun``): each is a rank of the data axis, on the device its caller
gives it.  The loader gives each rank its share of every batch
(SOLVER.IMS_PER_BATCH is the global batch), the mappers draw from cfg.SEED
plus the rank, the generators above are seeded alike on every rank (each
draws the global batch's numbers and keeps its rows), and the step is data
parallel (``engine/train_step.py``).  Rank 0 alone writes checkpoints and
metric files, then every rank waits for it; every rank restores.  test()
scores each rank's shard of every test set and merges the evaluators
(``evaluation/distributed.py``), so every rank holds the global metrics;
rank 0 prints them.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets import register_all_builtin
from ..data.loader import TrainLoader, device_batch, eval_loader
from ..data.mapper_panoptic_instance import (COCOInstanceLSJDatasetMapper,
                                             MaskFormerInstanceDatasetMapper,
                                             MaskFormerPanopticDatasetMapper, polygons_to_mask,
                                             rle_decode)
from ..data.mapper_semantic import COCOSemanticLSJDatasetMapper, MaskFormerSemanticDatasetMapper
from ..data.transforms import resize_nearest
from ..evaluation import (CityscapesInstanceEvaluator, InstanceSegEvaluator,
                          LVISInstanceSegEvaluator, PanopticEvaluator)
from ..evaluation.distributed import merge_across_processes
from ..evaluation.sem_seg_evaluation import (MaskFinerSemSegEvaluator, MetaLossSemSegEvaluator,
                                             SemSegEvaluator)
from ..losses.criterion import device_draw
from ..models.layers import set_dropout_generator
from ..models.inference import (instance_inference, panoptic_inference, sem_seg_postprocess,
                                sliding_window_semantic_scores, thing_lookup)
from ..models.maskformer import semantic_inference, upsample_masks
from ..models.registry import META_ARCHITECTURES, build_model, meta_architecture
from ..models.tta import SemanticSegmentorWithTTA
from ..parallel import mesh, precision
from .checkpoint import Checkpointer
from .convert_checkpoint import load_reference_weights
from .hooks import MetricLogger, device_memory_stats, nan_check
from .train_step import TrainStep


def require_trainable(cfg) -> None:
    """Raise, before anything is built, where the configured
    meta-architecture is not ported (its variants raise as the model is
    built)."""
    arch = meta_architecture(cfg)
    if arch not in META_ARCHITECTURES:
        raise NotImplementedError(f"training the {arch} meta-architecture is not ported (ROADMAP.md "
                                  f"section 1); ported: {sorted(META_ARCHITECTURES)}")


def eval_shard() -> Dict[str, int]:
    """This rank's shard of a test set, as ``eval_loader`` takes it."""
    return {"process_index": mesh.axis_index(), "process_count": mesh.axis_size()}


class Trainer:
    """``Trainer(cfg, device)``; ``resume_or_load()``; ``train()`` or ``test()``."""

    def __init__(self, cfg, device: torch.device, wandb_name: Optional[str] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        register_all_builtin()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.SEED)
            model = build_model(cfg)
        self.model = model.to(self.device)
        self.step_fn = TrainStep(self.model, cfg)
        self.generators = {
            "criterion": torch.Generator(device=self.device).manual_seed(cfg.SEED + 1),
            "dropout": torch.Generator(device=self.device).manual_seed(cfg.SEED + 2)}
        self.draw = device_draw(self.generators["criterion"])
        set_dropout_generator(self.model, self.generators["dropout"])
        if hasattr(self.model, "set_oracle_generator"):
            # the OracleTeacher cascades' teacher draws
            self.generators["oracle"] = torch.Generator(device=self.device).manual_seed(
                cfg.SEED + 3)
            self.model.set_oracle_generator(self.generators["oracle"])
        self.checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
        self.logger = MetricLogger(cfg.OUTPUT_DIR if self.is_main else None,
                                   wandb_name=wandb_name if self.is_main else None)
        self.start_step = 0
        self.results: Optional[Dict[str, Dict[str, float]]] = None   # of the latest test()

    # the data axis (parallel/mesh.py): this rank's shard of the data and its
    # mappers' seeds; the main process writes checkpoints and metric files
    @property
    def process_index(self) -> int:
        return mesh.axis_index()

    @property
    def process_count(self) -> int:
        return mesh.axis_size()

    @property
    def is_main(self) -> bool:
        return mesh.is_main()

    # -------------------------------------------------------------- resume
    def state(self, step: int) -> Dict:
        return {"step": step, "model": self.model.state_dict(),
                "generators": {k: g.get_state() for k, g in self.generators.items()},
                "optimizer": self.step_fn.optimizer.state_dict(),
                "scheduler": self.step_fn.scheduler.state_dict()}

    def load_state(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.step_fn.optimizer.load_state_dict(state["optimizer"])
        self.step_fn.scheduler.load_state_dict(state["scheduler"])
        for k, g in self.generators.items():
            g.set_state(state["generators"][k])
        self.start_step = int(state["step"])

    def resume_or_load(self, resume: bool = True) -> None:
        """Continue from the latest checkpoint under OUTPUT_DIR when ``resume``
        is set and there is one; else merge the reference checkpoint
        MODEL.WEIGHTS (``convert_checkpoint.load_reference_weights``: the
        entries it has, by name, with a count) when that file exists."""
        weights = self.cfg.MODEL.WEIGHTS
        if resume and self.checkpointer.latest_step() is not None:
            self.load_state(self.checkpointer.restore())
            if self.is_main:
                print(f"resumed from step {self.start_step}", flush=True)
        elif weights:
            load_reference_weights(self.model, weights)

    # --------------------------------------------------------------- train
    def build_train_loader(self) -> TrainLoader:
        """Threaded, shuffled, endless batches of SOLVER.IMS_PER_BATCH samples
        of DATASETS.TRAIN through the configured mapper, on the host."""
        cfg = self.cfg
        dataset = []
        for name in cfg.DATASETS.TRAIN:
            dataset += DatasetCatalog.get(name)
        if not dataset:
            raise FileNotFoundError(f"DATASETS.TRAIN {list(cfg.DATASETS.TRAIN)} hold no sample "
                                    "(are its files under $DETECTRON2_DATASETS?)")
        return TrainLoader(dataset, self.build_mapper(is_train=True), cfg.SOLVER.IMS_PER_BATCH,
                           seed=cfg.SEED, num_workers=cfg.DATALOADER.NUM_WORKERS,
                           process_index=self.process_index, process_count=self.process_count)

    def build_mapper(self, is_train: bool) -> Callable[[Dict], Dict]:
        """The mapper INPUT.DATASET_MAPPER_NAME names: coco_semantic2 (LSJ,
        training; its test mapper is the semantic one), mask_former_semantic
        and coco_semantic* (semantic), mask_former_panoptic,
        mask_former_instance, coco_instance_lsj and coco_panoptic_lsj (the
        LSJ instance mapper), drawing from cfg.SEED plus the rank."""
        cfg, seed = self.cfg, self.cfg.SEED + mesh.axis_index()
        name = cfg.INPUT.DATASET_MAPPER_NAME
        if name == "coco_semantic2" and is_train:
            return COCOSemanticLSJDatasetMapper.from_config(cfg, is_train=True, seed=seed)
        if name == "mask_former_semantic" or name.startswith("coco_semantic"):
            return MaskFormerSemanticDatasetMapper.from_config(cfg, is_train=is_train, seed=seed)
        if name == "mask_former_panoptic":
            return MaskFormerPanopticDatasetMapper.from_config(cfg, is_train=is_train, seed=seed)
        if name == "mask_former_instance":
            return MaskFormerInstanceDatasetMapper.from_config(cfg, is_train=is_train, seed=seed)
        if name in ("coco_instance_lsj", "coco_panoptic_lsj"):
            return COCOInstanceLSJDatasetMapper.from_config(cfg, is_train=is_train, seed=seed)
        raise ValueError(f"unknown mapper: {name}")

    def train(self, batches: Optional[Iterator[Dict[str, torch.Tensor]]] = None,
              max_iter: Optional[int] = None) -> None:
        """Steps start_step + 1 .. SOLVER.MAX_ITER, or up to ``max_iter`` when
        that is lower (the schedule still runs to SOLVER.MAX_ITER), one batch
        of ``batches`` each (by default of ``build_train_loader()``).  A
        checkpoint every SOLVER.CHECKPOINT_PERIOD steps and after the last
        one; ``test()`` every TEST.EVAL_PERIOD steps (0: never)."""
        require_trainable(self.cfg)
        solver, eval_period = self.cfg.SOLVER, self.cfg.TEST.EVAL_PERIOD
        loader = None
        if batches is None:
            loader = self.build_train_loader()
            batches = (device_batch(b, self.device) for b in loader)
        last = solver.MAX_ITER if max_iter is None else min(max_iter, solver.MAX_ITER)
        try:
            for step in range(self.start_step + 1, last + 1):
                batch = next(batches)
                t0 = time.perf_counter()
                metrics = {k: float(v) for k, v in self.step_fn(batch, self.draw).items()}
                metrics["seconds"] = time.perf_counter() - t0    # float() waited for the device
                metrics.update(device_memory_stats(self.device))
                self.logger.log(step, metrics)
                if not math.isfinite(metrics["total_loss"]):
                    nan_check(self.model, self.step_fn.optimizer)
                    raise FloatingPointError(f"non-finite loss at step {step}")
                if step % solver.CHECKPOINT_PERIOD == 0 or step == last:
                    if self.is_main:
                        self.checkpointer.save(step, self.state(step))
                    mesh.barrier()
                self.start_step = step
                if eval_period and step % eval_period == 0:
                    self.test()
        finally:
            if loader is not None:
                loader.close()
        self.checkpointer.wait()
        self.logger.close()

    # ---------------------------------------------------------------- eval
    def test(self) -> Dict[str, Dict[str, float]]:
        """{dataset: metrics} for each of DATASETS.TEST, by its metadata's
        evaluator_type (one evaluator per dataset: panoptic datasets get PQ
        alone, whatever TEST.*_ON say); checked against
        TEST.EXPECTED_RESULTS."""
        results = {}
        for name in self.cfg.DATASETS.TEST:
            etype = MetadataCatalog.get(name).get("evaluator_type", "sem_seg")
            if "panoptic" in etype:
                results[name] = self._eval_panoptic(name)
            elif "instance" in etype:
                results[name] = self._eval_instance(name)
            else:
                results[name] = self._eval_sem_seg(name)
            if mesh.is_main():
                print(f"[eval {name}] " + ", ".join(f"{k}={v:.2f}" for k, v in
                                                    results[name].items()
                                                    if not k.startswith("IoU-")), flush=True)
        self.results = results
        self.verify_results(results)
        return results

    def verify_results(self, results: Dict[str, Dict[str, float]]) -> bool:
        """Assert the metrics against TEST.EXPECTED_RESULTS, entries [task,
        metric, expected, tolerance] where task is a dataset name (or any
        name, then the metric is looked up alone)."""
        expected = self.cfg.TEST.EXPECTED_RESULTS
        if not expected:
            return True
        flat = {}
        for ds, metrics in results.items():
            for k, v in metrics.items():
                flat[f"{ds}/{k}"] = v
                flat[k] = v
        ok = True
        for task, metric, ref_val, tol in expected:
            key = f"{task}/{metric}" if f"{task}/{metric}" in flat else metric
            actual = flat.get(key)
            if actual is None or abs(actual - ref_val) > tol:
                ok = False
                print(f"[verify_results] FAIL {task}/{metric}: got {actual}, expected {ref_val} "
                      f"+/- {tol}")
            else:
                print(f"[verify_results] OK {task}/{metric}: {actual:.3f} (expected {ref_val} "
                      f"+/- {tol})")
        assert ok, "verify_results failed (see log)"
        return ok

    def _pad_eval_image(self, img: np.ndarray) -> np.ndarray:
        """Pad the bottom and right to the next multiple of
        MODEL.MASK_FORMER.SIZE_DIVISIBILITY with the rounded pixel mean: the
        reference pads the normalized image with zeros, which is the mean in
        raw pixels (zeros here would put a black border under the backbone).
        The serving predictor pads with zeros, as the demo does."""
        div = self.cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY
        h, w = img.shape[:2]
        out = np.empty((-(-h // div) * div, -(-w // div) * div, img.shape[2]), img.dtype)
        out[:] = np.round(np.asarray(self.cfg.MODEL.PIXEL_MEAN)).astype(img.dtype)
        out[:h, :w] = img
        return out

    def _scores(self, image: np.ndarray) -> torch.Tensor:
        """(nc, H, W) class scores of one (H, W, 3) uint8 model input."""
        out = precision.apply(
            self.model, torch.from_numpy(np.ascontiguousarray(image)).to(self.device)[None])
        masks = upsample_masks(out["pred_masks"], image.shape[:2])[0]
        return semantic_inference(out["pred_logits"][0], masks)

    def _padded_scores(self, image: np.ndarray) -> torch.Tensor:
        """(nc, h, w) class scores of an (h, w, 3) image: padded, through the
        model (window by window where TEST.SW_ENABLED, and always for
        MaskFinerOracleTeacherSW), cropped."""
        cfg = self.cfg
        h, w = image.shape[:2]
        padded = self._pad_eval_image(image)
        if cfg.TEST.SW_ENABLED or meta_architecture(cfg) == "MaskFinerOracleTeacherSW":
            sem = sliding_window_semantic_scores(self._scores, padded, cfg.TEST.SW_CROP_SIZE,
                                                 cfg.TEST.SW_STRIDE)
        else:
            sem = self._scores(padded)
        return sem[:, :h, :w]

    def eval_scores(self, image: np.ndarray, out_hw: Tuple[int, int]) -> torch.Tensor:
        """(nc, *out_hw) class scores on the device of one mapped test image
        (h, w, 3) uint8: over TEST.AUG's scales and flips where it is
        enabled, resized to the original size out_hw."""
        aug = self.cfg.TEST.AUG
        if aug.ENABLED:
            sem = SemanticSegmentorWithTTA(self._padded_scores, aug.MIN_SIZES, aug.MAX_SIZE,
                                           aug.FLIP)(image)
        else:
            sem = self._padded_scores(image)
        return sem_seg_postprocess(sem, image.shape[:2], out_hw)

    def _eval_sem_seg(self, dataset_name: str) -> Dict[str, float]:
        cfg = self.cfg
        meta = MetadataCatalog.get(dataset_name)
        arch = meta_architecture(cfg)
        ev_cls = SemSegEvaluator
        if "MaskFiner" in arch:
            ev_cls = MaskFinerSemSegEvaluator
        elif arch == "MaskFormerML":
            ev_cls = MetaLossSemSegEvaluator
        evaluator = ev_cls(cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                           ignore_label=meta.get("ignore_label", 255),
                           class_names=meta.get("stuff_classes"), output_dir=cfg.OUTPUT_DIR,
                           save_predictions=cfg.TEST.SAVE_EVAL_ARTIFACTS and bool(cfg.OUTPUT_DIR))
        mapper = MaskFormerSemanticDatasetMapper.from_config(cfg, is_train=False)
        with self._eval_mode():
            for sample in eval_loader(DatasetCatalog.get(dataset_name), mapper,
                                      **eval_shard()):
                sem = self.eval_scores(sample["image"], (sample["height"], sample["width"]))
                pred = sem.argmax(0).cpu().numpy()
                gt = sample["sem_seg"]
                if gt.shape != pred.shape:
                    # the ground truth went through the mapper's resize too
                    gt = resize_nearest(gt.astype(np.int32), pred.shape)
                evaluator.process(pred, gt, sample.get("file_name", ""))
        merge_across_processes(evaluator)
        return evaluator.evaluate()

    @contextlib.contextmanager
    def _eval_mode(self):
        """The model in eval mode without autograd; its mode restored after."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.model.train(was_training)

    def _predict_image(self, image: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (q, nc+1), mask logits (q, h, w)) on the device of one
        mapped (h, w, 3) uint8 test image: padded with the pixel mean, through
        the model, the masks upsampled to the padded size and cropped."""
        h, w = image.shape[:2]
        padded = self._pad_eval_image(image)
        out = precision.apply(
            self.model, torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)[None])
        masks = upsample_masks(out["pred_masks"], padded.shape[:2])[0]
        return out["pred_logits"][0], masks[:, :h, :w]

    def _eval_panoptic(self, dataset_name: str) -> Dict[str, float]:
        """PQ, SQ and RQ (all, things, stuff) of the panoptic inference at
        the mapped test size against the mapped ground truth."""
        cfg = self.cfg
        meta = MetadataCatalog.get(dataset_name)
        nc = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        thing_ids = set(meta.get("thing_dataset_id_to_contiguous_id", {}).values())
        evaluator = PanopticEvaluator(thing_ids, nc)
        mapper = MaskFormerPanopticDatasetMapper.from_config(cfg, is_train=False)
        test = cfg.MODEL.MASK_FORMER.TEST
        with self._eval_mode():
            for sample in eval_loader(DatasetCatalog.get(dataset_name), mapper,
                                      **eval_shard()):
                logits, masks = self._predict_image(sample["image"])
                pan, info = panoptic_inference(logits, masks, thing_ids, nc,
                                               test.OBJECT_MASK_THRESHOLD, test.OVERLAP_THRESHOLD)
                evaluator.process(pan.cpu().numpy(), info, sample["pan_seg"],
                                  sample["segments_info"])
        merge_across_processes(evaluator)
        return evaluator.evaluate()

    def _eval_instance(self, dataset_name: str) -> Dict[str, float]:
        """Mask AP: the mask logits resized to the original size, then the
        instance inference, against the annotations' masks (polygons or
        RLE) at the original size; an image with no annotation that is not
        crowd is skipped.  The protocol by evaluator_type or name:
        Cityscapes, LVIS (federated), else COCO; coco_instances_results.json
        goes to OUTPUT_DIR."""
        cfg = self.cfg
        meta = MetadataCatalog.get(dataset_name)
        nc = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        thing_ids = meta.get("thing_dataset_id_to_contiguous_id", {})
        is_thing = thing_lookup(thing_ids.values(), nc)
        etype = meta.get("evaluator_type", "")
        if "cityscapes" in etype or "cityscapes" in dataset_name:
            ev_cls = CityscapesInstanceEvaluator
        elif "lvis" in etype or "lvis" in dataset_name:
            ev_cls = LVISInstanceSegEvaluator
        else:
            ev_cls = InstanceSegEvaluator
        evaluator = ev_cls(nc, output_dir=cfg.OUTPUT_DIR or None,
                           contiguous_id_to_dataset_id={v: k for k, v in thing_ids.items()})
        mapper = MaskFormerInstanceDatasetMapper(is_train=False,
                                                 min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                                                 max_size_test=cfg.INPUT.MAX_SIZE_TEST)
        dataset = DatasetCatalog.get(dataset_name)
        with self._eval_mode():
            for d, sample in zip(dataset[mesh.axis_index()::mesh.axis_size()],
                                 eval_loader(dataset, mapper, **eval_shard())):
                logits, masks = self._predict_image(sample["image"])
                oh, ow = d.get("height"), d.get("width")
                # the mask logits resized to the original size, then thresholded
                masks = sem_seg_postprocess(masks, masks.shape[-2:], (oh, ow))
                inst = instance_inference(logits, masks, is_thing, nc,
                                          topk=cfg.TEST.DETECTIONS_PER_IMAGE,
                                          panoptic_on=cfg.MODEL.MASK_FORMER.TEST.PANOPTIC_ON)
                gl, gm = [], []
                for a in d.get("annotations", []):
                    if a.get("iscrowd", 0):
                        continue
                    seg = a.get("segmentation")
                    if isinstance(seg, list):
                        gm.append(polygons_to_mask(seg, oh, ow).astype(bool))
                    elif isinstance(seg, dict):
                        gm.append(rle_decode(seg).astype(bool))
                    else:
                        continue
                    gl.append(a["category_id"])
                if not gl:
                    continue
                evaluator.process(d.get("image_id", d["file_name"]), inst["masks"].cpu().numpy(),
                                  inst["labels"].cpu().numpy(), inst["scores"].cpu().numpy(),
                                  np.stack(gm), np.asarray(gl))
        merge_across_processes(evaluator)
        if mesh.is_main():
            evaluator.save_coco_results()
        return evaluator.evaluate()
