"""Classification trunks (port of yolo_dbl_tpu/models/, the backbones only)."""
