"""repro_torch: the distributed graph engine and LM token serving on
PyTorch and CUDA.

The paper's BFS and PageRank (a BGL-like BSP baseline and an
HPX-adapted fast variant of each) run as superstep programs over P
vertex blocks stacked on one device.  Beside them, the LM stack serves
tokens for every architecture family (dense, MoE, Mamba2, hybrid,
audio encoder-decoder, VLM): batched prefill, then greedy decode
against the KV and SSM caches; the dense family also trains.  The
package mirrors the layout of the JAX package ``repro`` module for
module, and never imports it:

  repro_torch.configs  -- GraphConfig and the graph workloads;
                          ModelConfig, the ten architectures, registry
  repro_torch.graphs   -- urand / rmat / smallworld edge generators
  repro_torch.core     -- partitioned graph, exchanges, local ops,
                          superstep loop, BFS, PageRank, registry,
                          GraphEngine
  repro_torch.models   -- parameter specs, layers, MoE and Mamba2
                          blocks, the Transformer of every family with
                          prefill and decode
  repro_torch.data     -- the deterministic synthetic token stream
  repro_torch.kernels  -- CUDA C++ kernels for Hopper (sm_90a), each
                          beside its plain-PyTorch version
  repro_torch.obs      -- telemetry series and wire records, spans,
                          reports and Chrome trace export
  repro_torch.launch   -- the graph-analytics launcher and the LM
                          serving driver
"""
