"""Structure blocks (port of part of yolo_dbl_tpu/nn/structures/): PConv,
FasterBlock, GhostModuleV2, GhostBottleneckV2 and TorchVision."""
