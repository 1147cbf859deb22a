"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

It imports torch, never jax, and nothing of ``repro``: modules it shares
with the JAX package (configs, the batcher, the LM data loader) are copies.
Module names mirror ``repro`` so each counterpart is found by its path.
Slice 1 covers the dense LM serving path (``launch.serve.serve_demo``) with
hand-written kernels for RMSNorm (Triton), flash attention and decode
attention (CUDA C++).  Slice 2 covers dense training (``launch.train.
build_trainer``, ``train.make_train_step``) with the fused LM-head cross
entropy forward and the flash-attention backward (CUDA C++) and the RMSNorm
backward (Triton).  Later slices add every family, the tabular path,
the service and the fabric, and (slice 15) the sharded LM substrate:
``distributed`` (one process per rank over ``torch.distributed``).
"""
