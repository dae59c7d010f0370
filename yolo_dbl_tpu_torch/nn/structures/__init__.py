"""Structure blocks (port of part of yolo_dbl_tpu/nn/structures/): PConv,
FasterBlock and TorchVision."""
