"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes bindings
and plain PyTorch versions, and the model-layout wrappers (``ops``).

main path kernels:  decode_attn.py (paged decode + chunked prefill, fp and
                    int8 pools; dense-cache decode), moe_gemm.py (hot
                    experts, ragged and capacity-padded), moe_gemv.py (cold
                    experts, likewise), ssd_decode.py (Mamba-2 decode step)
int8 recipe:        quant.py
build / counts:     build.py
"""
