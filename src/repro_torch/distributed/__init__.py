"""Distributed-training support.  Only the host-side fault-tolerance
module is ported so far; the activation-sharding policy and gradient
compression wait for the multi-card slice (ROADMAP.md, LM queue L6)."""
