"""Distributed-training support: the activation-sharding policy and the
per-rank pieces of a sharded step (``actctx.py``), the host-side
fault-tolerance module and int8 gradient compression with error
feedback (``compression.py``)."""

from repro_torch.distributed import actctx
from repro_torch.distributed.compression import compress_tree, \
    decompress_tree, dequantize_int8, init_ef_state, quantize_int8

__all__ = ["actctx", "compress_tree", "decompress_tree", "dequantize_int8",
           "init_ef_state", "quantize_int8"]
