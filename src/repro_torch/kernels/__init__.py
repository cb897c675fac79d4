"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
the JAX package that the port's main path runs.

  spmv            -- ELL SpMV (PageRank contribution sum)
  frontier        -- BFS pull step over a packed frontier bitmap
  flash_attention -- blocked online-softmax attention (LM prefill)

Each subpackage: csrc/*.cu (the kernel, with a plain C entry point),
kernel.py (the checked ctypes wrapper and its launch counter), ref.py
(the plain-PyTorch version, which runs for CPU tensors), ops.py (the
standalone entry point).  ``_build.py`` compiles every source
with nvcc at first use into ``build/kernels/``.
"""
