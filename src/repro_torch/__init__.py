"""repro_torch: the distributed graph engine on PyTorch and CUDA.

The paper's BFS and PageRank (a BGL-like BSP baseline and an
HPX-adapted fast variant of each) run as superstep programs over P
vertex blocks stacked on one device.  The package mirrors the layout of
the JAX package ``repro`` module for module, and never imports it:

  repro_torch.configs  -- GraphConfig and the graph workloads
  repro_torch.graphs   -- urand / rmat / smallworld edge generators
  repro_torch.core     -- partitioned graph, exchanges, local ops,
                          superstep loop, BFS, PageRank, registry,
                          GraphEngine
  repro_torch.kernels  -- CUDA C++ kernels for Hopper (sm_90a), each
                          beside its plain-PyTorch version
  repro_torch.launch   -- the graph-analytics launcher
"""
