"""PyTorch/CUDA port of the ``repro`` package (paged, chunked, duplex-MoE
serving on one NVIDIA Hopper GPU). It imports torch and numpy only — never
jax, and nothing of ``repro``. Layout mirrors ``repro``: ``configs``,
``models``, ``core``, ``kernels`` (hand-written CUDA kernels under
``kernels/csrc``) and ``serving``."""
