from .ops import moe_gmm

__all__ = ["moe_gmm"]
