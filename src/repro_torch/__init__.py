"""PyTorch / CUDA port of the SSDTrain reproduction.

Grows slice by slice beside the JAX package (`src/repro/`), which stays
the reference. It imports torch, numpy and the standard library only:
nothing of jax and nothing under `repro.`.

Slice 1 serves the paper's GPT: `repro_torch.launch.serve` with a paged
KV cache whose parked pages are evicted through the activation spool,
and prefill attention on a hand-written CUDA flash-attention kernel.
"""
