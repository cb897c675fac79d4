"""Distributed-training support: the host-side fault-tolerance module
and int8 gradient compression with error feedback
(``compression.py``).  The activation-sharding policy waits for the
sharded LM plans (ROADMAP.md, LM item L6b)."""

from repro_torch.distributed.compression import compress_tree, \
    decompress_tree, dequantize_int8, init_ef_state, quantize_int8

__all__ = ["compress_tree", "decompress_tree", "dequantize_int8",
           "init_ef_state", "quantize_int8"]
