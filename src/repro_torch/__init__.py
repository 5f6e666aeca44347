"""repro_torch — the IAAT small-GEMM stack ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version.
"""
