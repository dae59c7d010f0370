"""Adaptive pooling helpers of the attention catalogue, on NHWC tensors (port
of yolo_dbl_tpu/nn/attention/pooling.py).

JAX builds torch's AdaptiveAvgPool2d from integral images (bin edges
floor(i*I/O) .. ceil((i+1)*I/O)); here it is torch's own, on the NCHW view
of the same memory (channels_last on the card). The same edges hold when
the output is larger than the input (MLCA's un-pooling).
"""

from __future__ import annotations

from torch.nn import functional as F


def adaptive_avg_pool2d(x, out_hw):
    """NHWC adaptive average pool to (oh, ow), torch's bin edges (pooling.py:14)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), tuple(out_hw)).permute(0, 2, 3, 1)


def adaptive_avg_pool_h(x):
    """AdaptiveAvgPool2d((None, 1)): the mean over W → (B, H, 1, C) (pooling.py:41)."""
    return x.mean(dim=2, keepdim=True)


def adaptive_avg_pool_w(x):
    """AdaptiveAvgPool2d((1, None)): the mean over H → (B, 1, W, C) (pooling.py:46)."""
    return x.mean(dim=1, keepdim=True)
