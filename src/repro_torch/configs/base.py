"""Configuration dataclasses for models, LM shapes and graph workloads.

Every architecture is a ``ModelConfig``, complete enough to derive
parameter counts without instantiating weights.  A copy of the JAX
package's ``configs/base.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    attn_bias: bool = False          # qwen-style QKV bias
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    global_every: int = 0            # gemma3: every Nth layer is global, rest local
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2): shared attention block applied every N SSM layers ---
    hybrid_attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (frontend stub)
    cross_attention: bool = False

    # --- VLM (internvl): patch embeddings prepended (frontend stub) ---
    vision_tokens: int = 0

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu  (gelu => single up proj)
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"

    # which assigned shapes the arch supports (skips recorded in DESIGN.md)
    supports_long_context: bool = False   # sub-quadratic / SWA / SSM only
    supports_decode: bool = True

    notes: str = ""
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    # Derived quantities (used by roofline + memory budgeting)
    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def attn_params_per_layer(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.attn_bias else 0
        return q + kv + o + bias

    def mlp_params(self, d_ff: int) -> int:
        n_in = 2 if self.act == "swiglu" else 1
        return (n_in + 1) * self.d_model * d_ff

    def ssm_params_per_layer(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_nheads
        # in_proj -> [z, x, B, C, dt], conv on (x,B,C), out_proj, A/D/dt_bias/norm
        in_proj = d * (2 * di + 2 * self.ssm_groups * st + nh)
        conv = self.ssm_conv * (di + 2 * self.ssm_groups * st)
        out_proj = di * d
        extras = 3 * nh + di
        return in_proj + conv + out_proj + extras

    def params_total(self) -> int:
        """Total parameter count (embedding + all blocks + final norm/head)."""
        d = self.d_model
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        total = emb + head + d  # final norm
        norm_per_block = 2 * d

        if self.family in ("dense", "vlm"):
            per = self.attn_params_per_layer() + self.mlp_params(self.d_ff) + norm_per_block
            total += self.num_layers * per
        elif self.family == "moe":
            moe = self.num_experts * self.mlp_params(self.d_ff) + d * self.num_experts
            per = self.attn_params_per_layer() + moe + norm_per_block
            total += self.num_layers * per
        elif self.family == "ssm":
            total += self.num_layers * (self.ssm_params_per_layer() + d)
        elif self.family == "hybrid":
            total += self.num_layers * (self.ssm_params_per_layer() + d)
            # one shared attention+MLP block (parameters counted once)
            total += self.attn_params_per_layer() + self.mlp_params(self.d_ff) + norm_per_block
        elif self.family == "audio":
            enc = self.encoder_layers * (
                self.attn_params_per_layer() + self.mlp_params(self.d_ff) + norm_per_block
            )
            dec_per = (
                2 * self.attn_params_per_layer()  # self + cross
                + self.mlp_params(self.d_ff)
                + 3 * d
            )
            total += enc + self.num_layers * dec_per
        else:
            raise ValueError(f"unknown family {self.family}")
        return total

    def params_active(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.params_total()
        d = self.d_model
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per = (
            self.attn_params_per_layer()
            + self.num_experts_per_tok * self.mlp_params(self.d_ff)
            + d * self.num_experts
            + 2 * d
        )
        return emb + head + d + self.num_layers * per


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what program to lower and at what size."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes (identical across architectures).
TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

LM_SHAPES: Sequence[ShapeConfig] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """Shapes applicable to an architecture (skips per the assignment rules)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue  # pure full-attention arch: noted in DESIGN.md
        if s.kind == "decode" and not cfg.supports_decode:
            continue
        out.append(s)
    return out




@dataclass(frozen=True)
class GraphConfig:
    """Paper-side workload: an Erdos-Renyi ('urand') or RMAT graph."""

    name: str
    scale: int                # 2**scale vertices
    avg_degree: int = 16
    generator: str = "urand"  # urand | rmat | smallworld
    directed: bool = True

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def num_edges(self) -> int:
        return self.num_vertices * self.avg_degree


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (optimizer, schedule, fault
    tolerance).  Checkpoints default to ``build/ckpt`` under the working
    directory."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    remat: bool = True
    grad_accum: int = 1              # microbatches per step (activation memory / N)
    grad_compression: str = "none"   # none | int8_ef
    checkpoint_every: int = 100
    checkpoint_dir: str = "build/ckpt"
    keep_checkpoints: int = 3
