"""Roofline terms of a planned program.

Three terms per (program x graph x mesh), in seconds per call on a
target device:

  compute    = FLOPs_per_device / peak FLOP/s
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_wire_bytes_per_device / link bandwidth

The JAX package reads FLOPs and bytes from a compiled XLA artifact and
parses its HLO for the collectives.  The port has no HLO: FLOPs and
bytes come from ``jaxpr_cost.count_fn`` (a count of the torch ops a
planning run issues) and the collectives from the exchange tallies of
``core/partitioned.py::StackedComm`` (graph programs) or from the
counter's tally of the collectives a sharded LM step issued
(``Cost.collectives``), priced with the same ring model
(:func:`collective_stats`, :func:`funcol_stats`).  Each record carries two sets of terms: the
reference's TPU v5e terms under its keys, and the H100's under
``h100``.  The H100 prices a graph program's FLOPs at the f32 CUDA-core
peak (it runs no tensor-core work); an LM cell's counted matmul FLOPs
at the bf16 tensor-core peak and the rest at the f32 peak
(:func:`analyze`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# --- TPU v5e hardware constants (per chip), the JAX package's ---
PEAK_FLOPS_BF16 = 197e12       # FLOP/s
HBM_BW = 819e9                 # B/s
ICI_LINK_BW = 50e9             # B/s per link

# --- NVIDIA H100 SXM (per card, data-sheet peaks at 700 W) ---
H100_PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense, tensor cores
H100_PEAK_FLOPS_F32 = 67e12    # FLOP/s, CUDA cores
H100_HBM_BW = 3.35e12          # B/s
H100_NVLINK_BW = 450e9         # B/s a direction

# the exchange ops StackedComm tallies (bytes one part ships, T), as the
# collective the JAX package lowers each to, and the ring model's
# result-shape bytes and wire bytes of one part for a group of g parts
_COLLECTIVE = {
    "sum": "reduce-scatter",       # psum_scatter: result T/g, wire (g-1) T/g
    "or": "all-to-all",            # packed words: result T, wire (g-1)/g T
    "min": "all-to-all",           # result T, wire (g-1)/g T
    "bcast": "all-gather",         # result g T, wire (g-1) T
    "perm": "collective-permute",  # result T, wire T
    "psum": "all-reduce",          # a scalar: result T, wire 2 (g-1)/g T
}


def _ring(op: str, nbytes: float, g: int) -> tuple[float, float]:
    """(result bytes, wire bytes) of one part for tallied bytes ``nbytes``."""
    if op == "sum":
        return nbytes / g, (g - 1) * nbytes / g
    if op in ("or", "min"):
        return nbytes, (g - 1) / g * nbytes
    if op == "bcast":
        return g * nbytes, (g - 1) * nbytes
    if op == "perm":
        return nbytes, nbytes
    if op == "psum":
        return nbytes, 2.0 * (g - 1) / g * nbytes
    raise ValueError(f"no collective for exchange op {op!r}")


def collective_stats(tally: dict, parts: int) -> dict:
    """The JAX package's ``collectives`` record from exchange tallies.

    ``tally`` maps ``(phase, op)`` (or ``op``) to ``(bytes, calls)`` of
    one part, as ``StackedComm.tally()`` gives them (psum_scalar's
    all-reduces under op ``psum``).  Returns ``counts``, ``raw_bytes``
    (result-shape bytes) and ``wire_bytes`` by collective, their total
    ``wire_bytes_f32_upper`` and ``act_wire_bytes`` (0: graph payloads
    are shipped in their own dtype, bf16 included, so nothing is halved
    as the JAX package halves host-promoted payloads)."""
    counts, raw, wire = {}, {}, {}
    for key, (nbytes, calls) in tally.items():
        op = key[1] if isinstance(key, tuple) else key
        name = _COLLECTIVE[op]
        r, w = _ring(op, float(nbytes), parts)
        counts[name] = counts.get(name, 0.0) + float(calls)
        raw[name] = raw.get(name, 0.0) + r
        wire[name] = wire.get(name, 0.0) + w
    return {"counts": counts, "raw_bytes": raw, "wire_bytes": wire,
            "wire_bytes_f32_upper": sum(wire.values()),
            "act_wire_bytes": 0.0}


# DTensor's functional collectives, as the exchange op of the same ring
# cost (``_ring``: all-gather's result is g times its input,
# reduce-scatter's a g-th, the others' their input's size)
_FUNCOL = {"all_gather_into_tensor": "bcast",
           "reduce_scatter_tensor": "sum",
           "all_reduce": "psum",
           "all_to_all_single": "or"}


def funcol_stats(tally: dict) -> dict:
    """The reference's ``collectives`` record from a sharded plan's tally
    (``Cost.collectives``: ``(op, group size) -> (input bytes of one
    rank, calls)``), each op priced by the ring model at its own group
    size.  Payloads travel in their own dtype (bf16 activations as bf16),
    so ``act_wire_bytes`` is 0 and the total is the priced wire."""
    counts, raw, wire = {}, {}, {}
    for (op, g), (nbytes, calls) in tally.items():
        name = _COLLECTIVE[_FUNCOL[op]]
        res, w = _ring(_FUNCOL[op], float(nbytes), g)
        counts[name] = counts.get(name, 0.0) + float(calls)
        raw[name] = raw.get(name, 0.0) + res
        wire[name] = wire.get(name, 0.0) + w
    return {"counts": counts, "raw_bytes": raw, "wire_bytes": wire,
            "wire_bytes_f32_upper": sum(wire.values()),
            "act_wire_bytes": 0.0}


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_wire_bytes: float
    model_flops_total: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    peak_hbm_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    # the same terms on the H100 (see finalize)
    h100: dict = field(default_factory=dict)

    def finalize(self, matmul_flops_per_device: float | None = None):
        """Fill the terms.  On the H100, ``matmul_flops_per_device`` (an
        LM cell's counted matmul FLOPs) run at the bf16 tensor-core peak
        and the rest of the FLOPs at the f32 CUDA-core peak; without it
        (a graph program) every FLOP at the f32 peak."""
        self.compute_s = self.flops_per_device / PEAK_FLOPS_BF16
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_wire_bytes / ICI_LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_device * self.devices
        self.useful_flops_ratio = (
            self.model_flops_total / total if total else 0.0)
        rate = H100_PEAK_FLOPS_F32
        mm = matmul_flops_per_device or 0.0
        h = {"compute_s": mm / H100_PEAK_FLOPS_BF16
             + (self.flops_per_device - mm) / rate,
             "memory_s": self.bytes_per_device / H100_HBM_BW,
             "collective_s": self.collective_wire_bytes / H100_NVLINK_BW}
        rates = {"flops_per_s": rate}
        if matmul_flops_per_device is not None:
            rates["matmul_flops_per_s"] = H100_PEAK_FLOPS_BF16
        self.h100 = {**rates, "hbm_bytes_per_s": H100_HBM_BW,
                     "link_bytes_per_s": H100_NVLINK_BW, **h,
                     "bottleneck": max(h, key=h.get)[:-len("_s")]}
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); D = tokens.

    Train counts fwd+bwd (the 6N convention); inference programs count
    forward only (2N per token).
    """
    n = cfg.params_active()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def analyze(cost, *, arch: str, shape_name: str, mesh_name: str,
            devices: int, model_flops_total: float, arg_bytes: int,
            temp_bytes: int) -> Roofline:
    """The reference's ``analyze`` for a planned LM cell: a
    :class:`Roofline` from the counted ``cost`` (``jaxpr_cost.Cost``) of
    one device's step, on one card or on one device of a sharded plan.
    Bytes are the reference's fusion estimate of the graph records, a
    third of the unfused bytes (``roofline/recost.py`` replaces them
    with its analytic model); the collectives are the plan's tally
    (none on one card) priced by :func:`funcol_stats`; the peak is the
    argument bytes plus the planned temp bytes."""
    coll = funcol_stats(cost.collectives)
    r = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, devices=devices,
        flops_per_device=cost.total_flops,
        bytes_per_device=cost.bytes_touched / 3.0,
        collective_wire_bytes=coll["wire_bytes_f32_upper"],
        model_flops_total=model_flops_total,
        peak_hbm_bytes=float(arg_bytes + temp_bytes), collectives=coll)
    return r.finalize(cost.matmul_flops)
