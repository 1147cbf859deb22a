"""repro_torch.launch — entry points of the port."""

from __future__ import annotations

import torch

from ..kernels.decode_attention.kernel import HEAD_DIMS as DECODE_HEAD_DIMS
from ..kernels.flash_attention.kernel import BWD_HEAD_DIMS, HEAD_DIMS
from ..kernels.ssd.kernel import BWD_SHAPES as SSD_BWD_SHAPES
from ..models.config import ModelConfig


def _ssd_shape(cfg: ModelConfig) -> tuple[int, int] | None:
    """The SSD scan's (N, P) on ``cfg``'s path, None without one: the
    hybrid family's (state, head dim), the ssm family's mLSTM (d_head,
    d_head + 1) (its normalizer rides as a column of ones)."""
    if cfg.family == "hybrid":
        return cfg.ssm_state, cfg.ssm_head_dim
    if cfg.family == "ssm":
        return cfg.d_head, cfg.d_head + 1
    return None


def missing_backwards(cfg: ModelConfig) -> list[str]:
    """The kernels on ``cfg``'s training path that have no backward on the
    card: the SSD scan at an (N, P) outside the backward's shapes (zamba2's
    64 / 64 and xlstm's 512 / 513 have one) and the flash attention backward
    at a head dim outside ``BWD_HEAD_DIMS``.  The grouped expert matmul
    (moe) has its backward kernel."""
    missing = []
    shape = _ssd_shape(cfg)
    if shape is not None and shape not in SSD_BWD_SHAPES:
        missing.append(f"the SSD scan at N {shape[0]}, P {shape[1]} "
                       f"(kernels/ssd; its backward is built at "
                       f"{list(SSD_BWD_SHAPES)})")
    if cfg.uses_attention and cfg.d_head not in BWD_HEAD_DIMS:
        missing.append(f"the flash attention at head dim {cfg.d_head} "
                       f"(its backward is built at {list(BWD_HEAD_DIMS)})")
    return missing


def check_card_config(cfg: ModelConfig, device, *,
                      training: bool = False) -> None:
    """Raise ``ValueError`` before any parameter is allocated when ``cfg``
    would reach a CUDA kernel it does not take: the kernels take bf16, and
    the attention kernels the head dims of the repo's published configs.
    The reduced configs (fp32, head dim 32) are for the CPU.  With
    ``training`` a config is also refused when a kernel on its path has no
    backward (``missing_backwards``): no depth helps there.  Nothing is
    checked for a CPU device."""
    if torch.device(device).type != "cuda":
        return
    dims = sorted(set(HEAD_DIMS) & set(DECODE_HEAD_DIMS))
    head_ok = not cfg.uses_attention or cfg.d_head in dims
    verb = "train" if training else "serve"
    if cfg.dtype != "bfloat16" or not head_ok:
        takes = "bfloat16" + (f" and attention head dims {dims}"
                              if cfg.uses_attention else "")
        raise ValueError(
            f"{cfg.name} has dtype {cfg.dtype} and head dim {cfg.d_head}; "
            f"to {verb} on a CUDA device the kernels take {takes}.  The "
            f"reduced configs are for the CPU (--device cpu); on the card "
            f"give the published config (--full).")
    missing = missing_backwards(cfg) if training else []
    if missing:
        raise ValueError(
            f"{cfg.name} cannot train on a CUDA device: these kernels of "
            f"its path have no backward: {'; '.join(missing)} "
            f"(ROADMAP.md A3).")


__all__ = ["check_card_config", "missing_backwards"]
