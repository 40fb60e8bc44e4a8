"""memex_tpu_torch: the PyTorch + CUDA port of memex_tpu's data plane.

The ingest-and-search path runs here on an NVIDIA card (Hopper, sm_90a):
the MiniLM encoder in PyTorch, the flat index with its scan in a
hand-written CUDA kernel (csrc/fused_topk.cu), the fused query path and
the runtime that plugs them into memex_tpu's JAX-free control plane
(api/, db/, worker/, text/, config). This package imports torch and never
jax; memex_tpu stays the reference it is tested against.

Kernels are chosen by the tensor's device: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
