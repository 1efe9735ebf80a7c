"""The port's configuration: the node (``cfg_node``), the reader of the
configs' yaml subset (``yaml_reader``, no PyYAML), the default tree
(``defaults``) and the presets, short names for published yamls
(``presets``).

    cfg = published_cfg("configs/...yaml", ["KEY", "VALUE"])
    # = get_cfg(); add_deeplab_config(cfg); add_maskformer2_config(cfg)
    #   cfg.merge_from_file(...); cfg.merge_from_list([...])

or ``PRESETS[name]()`` for one of the presets.
"""

from .cfg_node import CfgNode
from .defaults import add_deeplab_config, add_maskformer2_config, get_cfg, published_cfg
from .presets import (PRESET_OVERRIDES, PRESET_YAMLS, PRESETS, aff_mini_15_cfg, aff_mini_cfg,
                      aff_mini_cityscapes_panoptic_cfg, aff_mini_coco_instance_cfg, aff_small_cfg,
                      maskfiner_mini_cfg, maskfiner_oracle_teacher_bb_cfg,
                      maskfiner_oracle_teacher_cfg, maskfiner_updown_mini_cfg,
                      maskfiner_updown_tiny_coco_panoptic_cfg, mrmean_mini_cfg, mrml_mini_cfg,
                      mrmlnb_mini_cfg, preset_cfg, r50_cfg, swin_base_384_res640_cfg,
                      swin_tiny_cfg, train_image_size)

__all__ = ["CfgNode", "get_cfg", "add_maskformer2_config", "add_deeplab_config",
           "published_cfg", "PRESETS", "PRESET_YAMLS", "PRESET_OVERRIDES", "preset_cfg",
           "train_image_size", "aff_mini_cfg", "aff_mini_15_cfg", "aff_small_cfg",
           "maskfiner_mini_cfg", "maskfiner_updown_mini_cfg",
           "maskfiner_updown_tiny_coco_panoptic_cfg", "maskfiner_oracle_teacher_bb_cfg",
           "maskfiner_oracle_teacher_cfg", "aff_mini_cityscapes_panoptic_cfg",
           "aff_mini_coco_instance_cfg", "r50_cfg", "swin_tiny_cfg", "swin_base_384_res640_cfg",
           "mrml_mini_cfg", "mrmlnb_mini_cfg", "mrmean_mini_cfg"]
