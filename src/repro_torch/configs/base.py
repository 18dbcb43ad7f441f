"""Config dataclasses for the port: model architecture and its layer pattern.

Own copy of the parts of ``repro.configs.base`` the ported slices need
(``LinearAttnConfig``, ``MoEConfig``, ``MambaConfig``, ``LayerSpec``,
``EncoderConfig``, ``ModelConfig``, ``ShapeConfig``, ``RunConfig``); the
port imports nothing of ``repro``.
Field names, defaults and derived properties match the reference so
configs compare one to one in the tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class LinearAttnConfig:
    """Linear-attention variant settings (paper §4 modules)."""

    feature_map: str = "identity"   # identity | elu1 | silu | relu | taylor
    decay: str = "none"             # none | retention | lightning | data
    backward: str = "faithful"      # faithful (Alg. 3/4) | autodiff
    block_size: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    n_shared_experts: int = 0       # dense "shared" experts (Moonlight-style)
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern.

    mixer: softmax | linear | mamba2 | hymba | cross
    mlp:   dense | moe | none
    """

    mixer: str = "softmax"
    mlp: str = "dense"
    sliding_window: Optional[int] = None   # softmax/hymba attention window
    is_global: bool = True                 # hymba: full-attention layer?


@dataclass(frozen=True)
class EncoderConfig:
    """Auxiliary encoder stack (Whisper). Frontend is a stub: the model
    consumes precomputed frame embeddings of shape (B, n_frames, d_model)."""

    n_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # layer pattern: `pattern` repeated `n_layers / len(pattern)` times.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    linear_attn: LinearAttnConfig = field(default_factory=LinearAttnConfig)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None
    # VLM: number of (stub) image tokens cross-attended by "cross" layers.
    n_image_tokens: int = 0

    dtype: str = "bfloat16"         # activations (compute)
    param_dtype: str = "float32"    # training master weights
    mlp_act: str = "swiglu"         # swiglu | gelu (tanh form)

    # padded so the vocab projection tiles evenly
    vocab_pad_multiple: int = 128

    # provenance note: [source; verified-tier]
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The spec of every layer, in order (``pattern`` tiled
        ``n_groups`` times): layer ``g·len(pattern) + p`` is
        ``pattern[p]``."""
        return self.pattern * self.n_groups

    @property
    def subquadratic(self) -> bool:
        """True if no layer does full (unwindowed) softmax attention over
        the text sequence: the ``long_500k`` rule. Hymba's three global
        layers decode linearly a step, so hymba counts as sub-quadratic
        for the decode-only long shape."""
        return not any(s.mixer == "softmax" and s.sliding_window is None
                       for s in self.pattern)

    def linearize(self, hybrid_every: int = 0) -> "ModelConfig":
        """Paper's Linear-X recipe: replace softmax mixers with linear
        attention; ``hybrid_every=4`` keeps every 4th softmax layer as
        softmax with a 2048-token window (the paper's 1/4 hybrid)."""
        unit = self.pattern
        if hybrid_every and len(unit) == 1:
            unit = unit * hybrid_every   # expand so every k-th can differ
        count = 0
        new = []
        for spec in unit:
            if spec.mixer != "softmax":
                new.append(spec)
                continue
            count += 1
            if hybrid_every and count % hybrid_every == 0:
                new.append(dataclasses.replace(spec, sliding_window=2048))
            else:
                new.append(dataclasses.replace(spec, mixer="linear",
                                               sliding_window=None))
        if self.n_layers % len(new):
            raise ValueError(
                f"n_layers={self.n_layers} not divisible by expanded "
                f"pattern {len(new)}")
        suffix = f"-hybrid{hybrid_every}" if hybrid_every else "-linear"
        return dataclasses.replace(self, name=self.name + suffix,
                                   pattern=tuple(new))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + the encoder;
        the final norms and the cross gates are left out, as in the
        reference)."""
        d, dh = self.d_model, self.head_dim
        n = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for spec in self.pattern:
            per = 2 * d  # two norms
            if spec.mixer in ("softmax", "linear", "cross"):
                per += d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
                per += (self.n_heads * dh) * d
            elif spec.mixer in ("mamba2", "hymba"):
                mb = self.mamba or MambaConfig()
                d_in = mb.expand * d if spec.mixer == "mamba2" else d
                nh = d_in // mb.headdim
                conv_ch = d_in + 2 * mb.ngroups * mb.d_state
                per += d * (2 * d_in + 2 * mb.ngroups * mb.d_state + nh)
                per += conv_ch * mb.d_conv + d_in * d + 2 * nh + d_in
                if spec.mixer == "hymba":
                    per += d * (self.n_heads * dh) \
                        + 2 * d * (self.n_kv_heads * dh) \
                        + (self.n_heads * dh) * d
            n_mats = 2 if self.mlp_act == "gelu" else 3
            if spec.mlp == "dense":
                per += n_mats * d * self.d_ff
            elif spec.mlp == "moe":
                moe = self.moe
                per += d * moe.num_experts  # router
                per += moe.num_experts * 3 * d * self.d_ff
                if moe.n_shared_experts:
                    per += n_mats * d * self.d_ff * moe.n_shared_experts
            n += per * self.n_groups
        if self.encoder is not None:
            enc_per = 2 * d + d * (self.n_heads * dh) \
                + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d \
                + (2 if self.mlp_act == "gelu" else 3) * d * self.d_ff
            n += enc_per * self.encoder.n_layers
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters: an MoE layer counts its top_k
        routed experts and its shared ones."""
        if self.moe is None:
            return self.param_count()
        moe = self.moe
        n_moe_layers = sum(1 for s in self.pattern if s.mlp == "moe") \
            * self.n_groups
        inactive = (moe.num_experts - moe.top_k) * 3 * self.d_model \
            * self.d_ff * n_moe_layers
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """A run's token shape: ``seq_len`` × ``global_batch`` of one kind
    (train | prefill | decode); ``obs.flops.model_flops`` reads it."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The reference's cell shapes (the dry run's, ``launch.cells``).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Per-run knobs of the train step (the fields of the reference's
    ``RunConfig`` the port's steps read; its compiled-step fields are not
    ported)."""

    num_microbatches: int = 1        # gradient accumulation steps
    remat: str = "full"              # full | dots | none
    learning_rate: float = 3e-4
    min_lr: float = 1e-6             # paper §4.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1        # paper §4.1
    grad_clip: float = 1.0           # paper §4.1
    adam_b1: float = 0.9             # paper §4.1
    adam_b2: float = 0.95            # paper §4.1
    seed: int = 0
    zero1: bool = True               # shard optimizer state over data ranks
    # SP communication (``repro_torch.comm``): the exchange strategy, its
    # overlap with the intra-chunk kernel, and the wire dtype of the state
    # and K/V exchanges (bf16 halves their bytes; combines stay fp32);
    # ``comm_spec()`` folds them into one validated ``CommSpec``. The
    # layout the step runs is ``launch.mesh.TrainingGroups``.
    comm_strategy: str = "allgather"   # allgather | ring | pipelined | ulysses
    comm_overlap: str = "overlap"    # overlap | none (A/B baseline)
    comm_dtype: str = "fp32"         # fp32 | bf16
    # The numerical health guard (``repro_torch.resilience.guard``): a
    # skip verdict on a non-finite loss or gradient (under a layout from
    # the one gradient all-reduce, which carries each rank's loss-health
    # scalar), rolling-median spike clipping, skip counters, and a
    # ``GuardAbort`` from the loop after this many consecutive skips.
    guard: bool = False
    guard_window: int = 32           # rolling grad-norm window (steps)
    guard_spike_factor: float = 4.0  # clip to factor × median on a spike
    guard_max_consecutive_skips: int = 8
    # Verify per-array SHA-256 checksums on restore; on a corrupt latest
    # checkpoint the loop falls back to the newest valid one.
    ckpt_verify: bool = True
    # Deterministic fault injection (drill and tests): NaN gradients at
    # these steps (guard on or off), a forced skip verdict at these steps
    # (read by the guard's verdict, as in the reference).
    chaos_nan_steps: Tuple[int, ...] = ()
    chaos_skip_steps: Tuple[int, ...] = ()
    # The reference's cross-pod int8 error-feedback gradient sync. It acts
    # only on a mesh with a "pod" axis, which the port has no twin of: on
    # one device the flag is accepted and inert, and the DP×SP(×TP) step
    # refuses it, as the reference's manual step does.
    grad_compression: bool = False
    # The DP×SP×TP degrees the train CLI was given (0 = unset; tp_degree 0
    # means 1). The step reads the layout (``TrainingGroups``), which the
    # CLI builds from these.
    dp_degree: int = 0
    sp_degree: int = 0
    tp_degree: int = 0
    # Cell building (``launch.cells``, the dry run): the per-rank tokens a
    # microbatch aims at; inference cells hold bf16 weights; prefill drops
    # FSDP when the weights over the model axis fit this many GiB.
    microbatch_tokens: int = 4096
    infer_bf16: bool = True
    infer_fsdp_budget_gb: float = 6.0

    def __post_init__(self):
        self.comm_spec()                 # bad comm knobs fail on any layout
        if self.guard_window < 1:
            raise ValueError(f"guard_window must be >= 1, got "
                             f"{self.guard_window}")
        if not self.guard_spike_factor > 0:
            raise ValueError(f"guard_spike_factor must be > 0, got "
                             f"{self.guard_spike_factor}")
        if self.guard_max_consecutive_skips < 1:
            raise ValueError(f"guard_max_consecutive_skips must be >= 1, "
                             f"got {self.guard_max_consecutive_skips}")
        for name in ("dp_degree", "sp_degree", "tp_degree"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = unset), got "
                                 f"{getattr(self, name)}")
        for name in ("chaos_nan_steps", "chaos_skip_steps"):
            steps = getattr(self, name)
            if not isinstance(steps, tuple) or not all(
                    isinstance(s, int) and s >= 0 for s in steps):
                raise ValueError(f"{name} must be a tuple of step indices "
                                 f">= 0, got {steps!r}")

    def comm_spec(self):
        """The validated ``comm.spec.CommSpec`` of this run."""
        from repro_torch.comm.spec import CommSpec
        return CommSpec(strategy=self.comm_strategy,
                        overlap=self.comm_overlap, dtype=self.comm_dtype)
