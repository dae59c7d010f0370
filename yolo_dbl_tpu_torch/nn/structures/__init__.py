"""Structure blocks (port of yolo_dbl_tpu/nn/structures/, `TorchVision` only)."""
