from .ops import ssd_scan, ssd_step

__all__ = ["ssd_scan", "ssd_step"]
