"""Model configs + presets for the built-in transformer family.

A copy of ``ray_tpu/models/config.py`` (pure Python, no device code): the
port keeps its own so that it imports nothing of the JAX package. The
presets, ``num_params`` and ``flops_per_token`` are the same; a config is
hashable and immutable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TransformerConfig:
    """Hashable, trace-static description of a decoder-only transformer."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None   # None => MHA (= n_heads); < n_heads => GQA
    head_dim: Optional[int] = None     # None => d_model // n_heads
    d_ff: Optional[int] = None         # None => 4*d_model (gelu) / ~8/3*d_model (swiglu)
    max_seq_len: int = 2048

    # architecture family knobs
    mlp: str = "swiglu"                # "swiglu" (llama) | "gelu" (gpt2)
    norm: str = "rms"                  # "rms" (llama) | "layer" (gpt2)
    positions: str = "rope"            # "rope" (llama) | "learned" (gpt2)
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # norm epsilon; None = family default (rms 1e-6, layer 1e-5). Real
    # checkpoints vary (llama-2/3 and mistral use 1e-5) — HF import sets
    # this from rms_norm_eps so parity is exact.
    norm_eps: Optional[float] = None
    # q/k/v projection biases (Qwen2; o_proj stays bias-free)
    attn_qkv_bias: bool = False

    # mixture of experts (0 => dense)
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    # sliding-window (local) attention: each token attends to its last N
    # keys only (0 = full causal). Mistral-style; applies to every layer.
    sliding_window: int = 0
    # per-layer window PATTERN (Gemma-2 alternation): a repeating tuple of
    # windows, one per layer, 0 = global. E.g. (4096, 0) = sliding on even
    # layers, global on odd. Overrides ``sliding_window`` when set;
    # n_layers must divide by the pattern length. The training stack scans
    # layer GROUPS of the pattern length so each sub-layer's window stays
    # static (the banded kernels need static block liveness).
    attn_windows: Optional[Tuple[int, ...]] = None
    # attention-logit tanh soft-capping (Gemma-2: 50.0; 0 = off), applied
    # inside every attention impl before masking — incl. the Pallas
    # kernels' fwd and bwd, so training matches real checkpoints exactly
    attn_softcap: float = 0.0

    # pipeline parallelism: microbatch count for the GPipe schedule when
    # the ambient mesh has pp > 1 (0 => 2 * pp, the usual bubble/memory
    # compromise); batch size must divide by it
    pp_microbatches: int = 0

    # numerics / memory
    dtype: str = "bfloat16"            # activation/param compute dtype
    param_dtype: str = "float32"       # master param dtype
    remat: bool = True                 # recompute each layer in backward (memory <-> FLOPs)
    # "full" recomputes the whole layer in backward; "save_attn" saves the
    # attention block's output (named checkpoint) so backward recomputes
    # only norms + QKV/FFN matmuls — attention (the expensive recompute:
    # its custom VJP already re-tiles the O(L^2) blocks) runs once
    remat_policy: str = "full"
    logits_softcap: float = 0.0        # tanh soft-capping (0 = off)
    z_loss: float = 0.0                # output z-loss weight
    # blockwise LM-head + cross entropy over C-token chunks (0 = off):
    # avoids materializing the [B, L, V] f32 logits (the largest single
    # train-step buffer); backward recomputes each chunk under remat
    loss_chunk: int = 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def ff(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.mlp == "swiglu":
            # llama-style: 2/3 * 4d rounded up to a multiple of 256
            raw = int(8 * self.d_model / 3)
            return (raw + 255) // 256 * 256
        return 4 * self.d_model

    def __post_init__(self):
        if self.remat_policy not in ("full", "save_attn"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                "expected 'full' or 'save_attn'")
        if self.attn_windows is not None:
            if not self.attn_windows or any(
                    not isinstance(w, int) or w < 0
                    for w in self.attn_windows):
                raise ValueError(
                    f"attn_windows must be a non-empty tuple of ints >= 0 "
                    f"(0 = global), got {self.attn_windows!r}")
            if self.n_layers % len(self.attn_windows):
                raise ValueError(
                    f"n_layers {self.n_layers} not divisible by the "
                    f"attn_windows pattern length {len(self.attn_windows)}")

    @property
    def window_pattern(self) -> Tuple[int, ...]:
        """The repeating per-layer window pattern (0 = global)."""
        if self.attn_windows is not None:
            return tuple(self.attn_windows)
        return (self.sliding_window,)

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        """Window per layer, expanded to all n_layers."""
        pat = self.window_pattern
        return pat * (self.n_layers // len(pat))

    @property
    def uniform_window(self) -> int:
        """The single window shared by ALL layers, or 0 when layers mix
        (or no window). Ring KV caches require a uniform window."""
        pat = set(self.window_pattern)
        return self.window_pattern[0] if len(pat) == 1 else 0

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    def num_params(self) -> int:
        """Parameter count (embeddings included once if tied)."""
        d, f, hd = self.d_model, self.ff, self.hdim
        attn = d * hd * self.n_heads + 2 * d * hd * self.kv_heads + hd * self.n_heads * d
        if self.attn_qkv_bias:
            attn += hd * (self.n_heads + 2 * self.kv_heads)
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f + f + d  # + b_in/b_out biases
        if self.num_experts:
            mlp = mlp * self.num_experts + d * self.num_experts  # + router
        norms = 2 * d
        final_norm = d
        if self.norm == "layer":  # per-norm bias vectors
            norms += 2 * d
            final_norm += d
        per_layer = attn + mlp + norms
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        pos = self.max_seq_len * d if self.positions == "learned" else 0
        return self.n_layers * per_layer + emb + head + pos + final_norm

    def flops_per_token(self) -> int:
        """Approx training FLOPs/token (fwd+bwd ≈ 6N + attention quadratic)."""
        n = self.num_params()
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return 6 * (n - emb)


# ---------------------------------------------------------------------------
# Presets. llama3_* mirror public Llama-3 shapes; *_debug are CI-sized.
# ---------------------------------------------------------------------------

def llama3_8b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192, mlp="swiglu", norm="rms",
        positions="rope", rope_theta=500000.0,
    )


def llama3_70b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        d_ff=28672, max_seq_len=8192, mlp="swiglu", norm="rms",
        positions="rope", rope_theta=500000.0,
    )


def llama_1b() -> TransformerConfig:
    """~1.2B params."""
    return TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq_len=4096,
    )


def llama_250m() -> TransformerConfig:
    """~250M-param model (the JAX package's bench workload)."""
    return TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=12, n_heads=16, n_kv_heads=8,
        d_ff=2816, max_seq_len=2048,
    )


def llama_debug() -> TransformerConfig:
    """Tiny config for tests and the multichip dryrun."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False,
    )


def gpt2_small() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=50257, d_model=768, n_layers=12, n_heads=12,
        d_ff=3072, max_seq_len=1024, mlp="gelu", norm="layer",
        positions="learned", tie_embeddings=True,
    )


def gpt2_debug() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4,
        d_ff=256, max_seq_len=128, mlp="gelu", norm="layer",
        positions="learned", tie_embeddings=True, remat=False,
    )


def gemma2_9b() -> TransformerConfig:
    """Gemma-2-9B-family shape: GQA, tied embeddings, tanh softcaps on
    both attention logits (50.0) and output logits (30.0), and the EXACT
    per-layer alternating windows — sliding 4096 on even layers, global on
    odd (HF gemma-2 ``layer_types`` order: layer 0 is sliding). Remaining
    known delta vs the real checkpoint: Gemma-2's pre+post sandwich norms
    are modeled as pre-norms only."""
    return TransformerConfig(
        vocab_size=256128, d_model=3584, n_layers=42, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=14336, max_seq_len=8192,
        tie_embeddings=True, logits_softcap=30.0, attn_softcap=50.0,
        attn_windows=(4096, 0),
    )


def gemma_debug() -> TransformerConfig:
    """Tiny gemma-2-style config for tests: alternating windows (local
    layer 0, global layer 1), attention + logits softcaps, GQA, tied
    embeddings."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, tie_embeddings=True, logits_softcap=30.0,
        attn_softcap=50.0, attn_windows=(24, 0),
        remat=False,
    )


def mistral_7b() -> TransformerConfig:
    """Mistral-7B-family shape: GQA + 4096-token sliding-window attention."""
    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192, sliding_window=4096,
    )


def mistral_debug() -> TransformerConfig:
    """Tiny sliding-window config for tests."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, sliding_window=24, remat=False,
    )


def qwen2_7b() -> TransformerConfig:
    """Qwen2-7B-family shape: GQA + q/k/v biases, large vocab, theta 1M.
    Weight-portable via ``models.import_hf`` (exact parity incl. the
    bias path)."""
    return TransformerConfig(
        vocab_size=152064, d_model=3584, n_layers=28, n_heads=28,
        n_kv_heads=4, d_ff=18944, max_seq_len=32768,
        rope_theta=1_000_000.0, norm_eps=1e-6, attn_qkv_bias=True,
    )


def qwen2_debug() -> TransformerConfig:
    """Tiny qwen2-style config for tests: GQA + qkv biases."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, attn_qkv_bias=True, remat=False,
    )


def moe_debug() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=128, max_seq_len=128, num_experts=4, expert_top_k=2, remat=False,
    )


PRESETS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama-1b": llama_1b,
    "llama-250m": llama_250m,
    "llama-debug": llama_debug,
    "gpt2-small": gpt2_small,
    "gpt2-debug": gpt2_debug,
    "gemma2-9b": gemma2_9b,
    "gemma-debug": gemma_debug,
    "mistral-7b": mistral_7b,
    "mistral-debug": mistral_debug,
    "qwen2-7b": qwen2_7b,
    "qwen2-debug": qwen2_debug,
    "moe-debug": moe_debug,
}


def get_config(name: str) -> TransformerConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
