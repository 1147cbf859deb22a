from .ops import flash_attention, flash_attention_bwd

__all__ = ["flash_attention", "flash_attention_bwd"]
