"""Attention modules of the port beyond area attention (nn/blocks.py AAttn)."""

from .sla import SLA, sparse_linear_attention

__all__ = ["SLA", "sparse_linear_attention"]
