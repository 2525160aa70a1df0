"""Configuration dataclasses of the port (own copy of
``repro/configs/base.py``, field for field).

Every architecture is described by a ``ModelConfig``; a training run by
a ``ShapeConfig`` (sequence length x global batch) and a
``TrainConfig``.  Configs are plain frozen dataclasses so they hash,
compare, and print deterministically.  ``MeshConfig`` and the sharding
knobs of ``TrainConfig`` (``zero3``, ``grad_compression``,
``hierarchical_allreduce``) belong to the sharding slice and are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

if TYPE_CHECKING:
    from repro_torch.core.policy import OffloadPolicy

BlockKind = Literal["attention", "mamba2", "rwkv6", "shared_attention"]
ModelKind = Literal["decoder", "encoder_decoder"]
Frontend = Literal["none", "audio", "vision"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one FFN block family."""

    num_experts: int
    top_k: int
    # capacity factor for fixed-capacity dispatch (train path); decode uses
    # dense-gather dispatch which needs no capacity.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block settings."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) block settings."""

    head_dim: int = 64
    # decay lora rank (data-dependent decay projection)
    decay_lora: int = 64
    gate_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Field names follow the assignment table."""

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    kind: ModelKind = "decoder"

    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 16
    d_ff: int = 4096
    vocab_size: int = 32000
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0  # 0 -> full attention
    rope_theta: float = 10000.0

    # norm / activation
    norm_eps: float = 1e-5
    act: str = "silu"  # silu | gelu | relu
    gated_mlp: bool = True  # SwiGLU-family vs classic 2-matrix FFN
    tie_embeddings: bool = False

    # encoder (enc-dec only)
    enc_num_layers: int = 0
    enc_seq_len: int = 0  # fixed encoder memory length for serving shapes

    # heterogeneous stacks: pattern of block kinds, cycled over num_layers.
    # e.g. zamba2: mostly mamba2 with a shared attention block every k.
    block_pattern: tuple[BlockKind, ...] = ("attention",)

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None

    frontend: Frontend = "none"
    # frontend stub: number of precomputed embedding frames/patches fed to
    # the backbone for [audio]/[vlm] archs (input_specs provides these).
    frontend_len: int = 0

    dtype: str = "bfloat16"
    source: str = ""  # citation tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state is O(1)/bounded (may run long_500k)."""
        if any(k in ("mamba2", "rwkv6") for k in self.block_pattern):
            return True
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec included)

    def layer_kinds(self) -> tuple[BlockKind, ...]:
        """The per-layer block kind for the decoder stack."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        def attn_params() -> int:
            p = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
            if self.qkv_bias:
                p += nq * h + 2 * nkv * h
            return p
        def ffn_params() -> int:
            n_mats = 3 if self.gated_mlp else 2
            dense = n_mats * d * self.d_ff
            if self.moe is not None:
                return self.moe.num_experts * dense + d * self.moe.num_experts
            return dense
        def mamba_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            p = d * (2 * d_in + 2 * s.state_dim + nheads)  # in_proj(zxbcdt)
            p += s.conv_width * (d_in + 2 * s.state_dim)
            p += d_in * d  # out_proj
            p += 2 * nheads  # A_log, D
            return p
        def rwkv_params() -> int:
            r = self.rwkv or RWKVConfig()
            p = 4 * d * d  # r,k,v,output
            p += d * r.decay_lora + r.decay_lora * d  # decay lora
            p += d * r.gate_lora + r.gate_lora * d  # gate lora
            p += 6 * d  # token-shift mixes
            p += d * self.d_ff + self.d_ff * d  # channel mix
            return p
        for kind in self.layer_kinds():
            total += 2 * d  # norms
            if kind in ("attention", "shared_attention"):
                total += attn_params() + ffn_params()
            elif kind == "mamba2":
                total += mamba_params() + ffn_params()
            elif kind == "rwkv6":
                total += rwkv_params()
        for _ in range(self.enc_num_layers):
            total += 2 * d + attn_params() + ffn_params()
            if self.kind == "encoder_decoder":
                # decoder cross-attention (one per decoder layer accounted here
                # as enc side for simplicity of the analytic count)
                pass
        if self.kind == "encoder_decoder":
            total += self.num_layers * (d + attn_params())  # cross attn + norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        dense = 3 * d * self.d_ff
        n_moe_layers = sum(
            1 for k in self.layer_kinds() if k in ("attention", "shared_attention")
        )
        inactive = n_moe_layers * (self.moe.num_experts - self.moe.top_k) * dense
        return full - inactive



@dataclass(frozen=True)
class ShapeConfig:
    """A workload shape cell: (kind, seq_len, global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"] = "train"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters and runtime knobs (one device)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation factor
    remat: bool = True
    seed: int = 0
    # the offload compiler (§IV-B1): ``offload`` switches it on;
    # ``offload_policy`` (a repro_torch.core.policy.OffloadPolicy) picks
    # the decision backend and planner knobs — None leaves the wrapper
    # unpinned, resolving the active ``with offload_policy(...):`` scope
    # (else the default greedy policy) at call time.
    offload: bool = False
    offload_policy: "OffloadPolicy | None" = None
    # fault tolerance: a checkpoint every this many steps, under
    # ``checkpoint_dir``, the newest ``keep_checkpoints`` kept.  Unlike the
    # reference (100, under a fixed /tmp path) ``checkpoint_every``
    # defaults to 0 and a positive value needs a directory: no run
    # silently resumes another's state.  A directory alone restores from
    # it without saving.
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    # hard per-step wall-time deadline (0 = disabled): a step exceeding
    # it is flagged by StragglerMonitor and the loop force-commits a
    # checkpoint (train.loop)
    step_deadline_s: float = 0.0

    def __post_init__(self):
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError(
                "TrainConfig.checkpoint_every > 0 needs checkpoint_dir "
                "(no default directory: a run must not resume another's "
                "state by accident)")

    def resolved_offload_policy(self) -> "OffloadPolicy | None":
        """The policy the train step pins (None: unpinned)."""
        return self.offload_policy


def reduced(config: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        num_layers=max(2, min(4, len(config.block_pattern))),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, config.num_kv_heads * 4 // config.num_heads)),
        d_ff=128,
        vocab_size=256,
        head_dim=16,
    )
    if config.enc_num_layers:
        small["enc_num_layers"] = 2
        small["enc_seq_len"] = 16
    if config.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=min(4, config.moe.num_experts), top_k=min(2, config.moe.top_k)
        )
    if config.ssm is not None:
        small["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16)
    if config.rwkv is not None:
        small["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8)
    if config.sliding_window:
        small["sliding_window"] = 8
    if config.frontend != "none":
        small["frontend_len"] = 8
    small.update(overrides)
    return dataclasses.replace(config, **small)
