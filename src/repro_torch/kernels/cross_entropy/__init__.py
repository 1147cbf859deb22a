from .ops import ce_forward, fused_cross_entropy

__all__ = ["ce_forward", "fused_cross_entropy"]
