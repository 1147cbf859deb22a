from .ops import rmsnorm, rmsnorm_bwd

__all__ = ["rmsnorm", "rmsnorm_bwd"]
