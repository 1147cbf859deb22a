"""repro_torch.launch — entry points of the port."""

from __future__ import annotations

import torch

from ..kernels.decode_attention.kernel import HEAD_DIMS as DECODE_HEAD_DIMS
from ..kernels.flash_attention.kernel import BWD_HEAD_DIMS, HEAD_DIMS
from ..models.config import ModelConfig


def check_card_config(cfg: ModelConfig, device, *,
                      training: bool = False) -> None:
    """Raise ``ValueError`` before any parameter is allocated when ``cfg``
    would reach a CUDA kernel it does not take: the kernels take bf16, and
    the attention kernels the head dims of the repo's published configs
    (the flash backward 128 only).  That holds for every family, the vlm
    and audio ones (internvl2-76b at head dim 128, musicgen-medium at 64)
    too.  The reduced configs (fp32, head dim 32) are for the CPU.  Nothing
    is checked for a CPU device."""
    if torch.device(device).type != "cuda":
        return
    dims = sorted(set(HEAD_DIMS) & set(DECODE_HEAD_DIMS))
    if training:
        dims = sorted(set(dims) & set(BWD_HEAD_DIMS))
    head_ok = not cfg.uses_attention or cfg.d_head in dims
    if cfg.dtype == "bfloat16" and head_ok:
        return
    fix = "--full --layers N" if training else "--full"
    takes = "bfloat16" + (f" and attention head dims {dims}"
                          if cfg.uses_attention else "")
    raise ValueError(
        f"{cfg.name} has dtype {cfg.dtype} and head dim {cfg.d_head}; to "
        f"{'train' if training else 'serve'} on a CUDA device the kernels "
        f"take {takes}.  The reduced configs are for the CPU (--device cpu); "
        f"on the card give the published config ({fix}).")


__all__ = ["check_card_config"]
