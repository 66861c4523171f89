"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes bindings
and plain PyTorch versions, and the model-layout wrappers (``ops``).

main path kernels:  decode_attn.py (paged decode + chunked prefill, fp and
                    int8 pools), moe_gemm.py (hot experts, ragged and
                    capacity-padded), moe_gemv.py (cold experts, likewise)
int8 recipe:        quant.py
build / counts:     build.py
"""
