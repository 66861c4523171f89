"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes bindings
and plain PyTorch versions, and the model-layout wrappers (``ops``).

main path kernels:  decode_attn.py (paged decode + chunked prefill),
                    moe_gemm.py (hot experts), moe_gemv.py (cold experts)
build / counts:     build.py
"""
