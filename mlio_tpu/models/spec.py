"""Model architecture specs and implementation choices.

The reference loads mutable PyTorch models from HF and monkeypatches modules
(/root/reference/baseline/model_loader.py:56-154, inference.py:283-375).
This design owns the model definition instead: a :class:`ModelSpec`
describes the architecture, parameters live in a plain pytree, and
:class:`Impl` selects compile-time implementation choices (which kernel,
which cache, which quantization) — replacing the reference's runtime module
surgery with constructors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture description covering the GPT-2 and Llama families.

    Capability parity with the model coverage of the reference's loaders and
    converters (model_loader.py:368-460, flash_attention.py:952-1168): any
    decoder-only transformer with learned or rotary positions, LayerNorm or
    RMSNorm, GELU or SwiGLU MLPs, MHA or GQA/MQA attention.
    """

    name: str = "gpt2"
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12  # < num_heads => GQA; == 1 => MQA
    intermediate_size: int = 3072
    max_seq_len: int = 1024
    head_dim: Optional[int] = None  # default hidden_size // num_heads

    # Architecture knobs
    activation: str = "gelu_new"  # "gelu_new"|"gelu"|"relu"|"swiglu"|"geglu"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    positional: str = "learned"  # "learned" | "rope"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # partial rotary (GPT-NeoX rotary_pct, Phi)
    use_qkv_bias: bool = True
    use_mlp_bias: bool = True
    use_out_bias: bool = True
    tie_embeddings: bool = True
    logits_softcap: Optional[float] = None
    # Parallel residual: x + attn(ln1(x)) + mlp(ln2(x)) (GPT-NeoX family);
    # shared_ln additionally feeds BOTH branches from ln1 (Phi family).
    parallel_residual: bool = False
    shared_ln: bool = False
    embed_scale: Optional[float] = None  # Gemma: sqrt(hidden_size)
    use_head_bias: bool = False  # Phi: lm_head carries a bias
    # Mixture-of-Experts (Mixtral family). 0 experts = dense MLP. The
    # reference has no MoE/EP support (SURVEY.md §2.5) — capability addition.
    num_experts: int = 0
    num_experts_per_tok: int = 2

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_size

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_size

    @property
    def group_size(self) -> int:
        """Query heads per KV head (GQA group)."""
        return self.num_heads // self.num_kv_heads

    @property
    def rope_dim(self) -> int:
        """Rotated prefix of each head (even; == head_size when fraction=1)."""
        return int(self.head_size * self.rope_fraction) // 2 * 2

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, "heads must divide evenly into KV groups"
        if self.head_dim is None:
            assert self.hidden_size % self.num_heads == 0
        if self.num_experts:
            assert 0 < self.num_experts_per_tok <= self.num_experts

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        h, i, l, v = self.hidden_size, self.intermediate_size, self.num_layers, self.vocab_size
        attn = h * self.q_dim + 2 * h * self.kv_dim + self.q_dim * h
        mlp = (3 if self.activation in ("swiglu", "geglu") else 2) * h * i
        if self.num_experts:
            mlp = self.num_experts * mlp + h * self.num_experts  # + router
        per_layer = attn + mlp + 4 * h
        embed = v * h + (self.max_seq_len * h if self.positional == "learned" else 0)
        head = 0 if self.tie_embeddings else v * h
        return embed + l * per_layer + head


def _gpt2(name: str, hidden: int, layers: int, heads: int) -> ModelSpec:
    return ModelSpec(
        name=name,
        vocab_size=50257,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=heads,
        intermediate_size=4 * hidden,
        max_seq_len=1024,
        activation="gelu_new",
        norm="layernorm",
        positional="learned",
        tie_embeddings=True,
    )


def _llama(name: str, hidden: int, layers: int, heads: int, kv_heads: int,
           intermediate: int, vocab: int = 32000, max_seq: int = 4096,
           rope_theta: float = 10000.0) -> ModelSpec:
    return ModelSpec(
        name=name,
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv_heads,
        intermediate_size=intermediate,
        max_seq_len=max_seq,
        activation="swiglu",
        norm="rmsnorm",
        norm_eps=1e-5,
        positional="rope",
        rope_theta=rope_theta,
        use_qkv_bias=False,
        use_mlp_bias=False,
        use_out_bias=False,
        tie_embeddings=False,
    )


PRESETS = {
    # GPT-2 family (model_loader.py registry patterns "gpt2.*")
    "gpt2": _gpt2("gpt2", 768, 12, 12),
    "gpt2-medium": _gpt2("gpt2-medium", 1024, 24, 16),
    "gpt2-large": _gpt2("gpt2-large", 1280, 36, 20),
    "gpt2-xl": _gpt2("gpt2-xl", 1600, 48, 25),
    # Llama-2 family
    "llama2-7b": _llama("llama2-7b", 4096, 32, 32, 32, 11008),
    "llama2-13b": _llama("llama2-13b", 5120, 40, 40, 40, 13824),
    "llama2-70b": _llama("llama2-70b", 8192, 80, 64, 8, 28672),
    # Llama-3 family (GQA everywhere, larger vocab, theta=500k)
    "llama3-8b": _llama("llama3-8b", 4096, 32, 32, 8, 14336, vocab=128256,
                        max_seq=8192, rope_theta=500000.0),
    "llama3-70b": _llama("llama3-70b", 8192, 80, 64, 8, 28672, vocab=128256,
                         max_seq=8192, rope_theta=500000.0),
    # Mistral (sliding-window unused at these context lengths)
    "mistral-7b": _llama("mistral-7b", 4096, 32, 32, 8, 14336,
                         max_seq=8192),
    # Qwen2 (Llama-like + Q/K/V biases)
    "qwen2-7b": dataclasses.replace(
        _llama("qwen2-7b", 3584, 28, 28, 4, 18944, vocab=152064,
               max_seq=8192, rope_theta=1000000.0),
        use_qkv_bias=True),
    # GPT-NeoX / Pythia (parallel residual, partial rotary)
    "pythia-1.4b": ModelSpec(
        name="pythia-1.4b", vocab_size=50304, hidden_size=2048,
        num_layers=24, num_heads=16, num_kv_heads=16,
        intermediate_size=8192, max_seq_len=2048, activation="gelu",
        norm="layernorm", positional="rope", rope_fraction=0.25,
        tie_embeddings=False, parallel_residual=True),
    # Phi-2 (parallel residual with one shared LN, partial rotary, head bias)
    "phi-2": ModelSpec(
        name="phi-2", vocab_size=51200, hidden_size=2560, num_layers=32,
        num_heads=32, num_kv_heads=32, intermediate_size=10240,
        max_seq_len=2048, activation="gelu_new", norm="layernorm",
        positional="rope", rope_fraction=0.4, tie_embeddings=False,
        use_head_bias=True, parallel_residual=True, shared_ln=True),
    # OPT (learned positions with folded +2 offset, ReLU MLP)
    "opt-1.3b": ModelSpec(
        name="opt-1.3b", vocab_size=50272, hidden_size=2048, num_layers=24,
        num_heads=32, num_kv_heads=32, intermediate_size=8192,
        max_seq_len=2048, activation="relu", norm="layernorm",
        positional="learned", tie_embeddings=True),
    # Gemma (GeGLU, (1+w) norms folded at conversion, scaled embeddings)
    "gemma-7b": ModelSpec(
        name="gemma-7b", vocab_size=256000, hidden_size=3072, num_layers=28,
        num_heads=16, num_kv_heads=16, intermediate_size=24576,
        max_seq_len=8192, head_dim=256, activation="geglu", norm="rmsnorm",
        norm_eps=1e-6, positional="rope", use_qkv_bias=False,
        use_mlp_bias=False, use_out_bias=False, tie_embeddings=True,
        embed_scale=3072.0 ** 0.5),
    # Mixtral (sparse MoE: 8 SwiGLU experts, top-2 routing)
    "mixtral-8x7b": dataclasses.replace(
        _llama("mixtral-8x7b", 4096, 32, 32, 8, 14336, max_seq=8192,
               rope_theta=1000000.0),
        num_experts=8, num_experts_per_tok=2),
    # Tiny variants for tests (same topology, small dims)
    "gpt2-tiny": dataclasses.replace(
        _gpt2("gpt2-tiny", 64, 2, 4), vocab_size=256, max_seq_len=128,
        intermediate_size=256),
    "llama-tiny": dataclasses.replace(
        _llama("llama-tiny", 64, 2, 4, 2, 128, vocab=256, max_seq=128)),
    "moe-tiny": dataclasses.replace(
        _llama("moe-tiny", 64, 2, 4, 2, 128, vocab=256, max_seq=128),
        num_experts=4, num_experts_per_tok=2),
    "neox-tiny": ModelSpec(
        name="neox-tiny", vocab_size=256, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=4, intermediate_size=256, max_seq_len=128,
        activation="gelu", norm="layernorm", positional="rope",
        rope_fraction=0.25, tie_embeddings=False, parallel_residual=True),
}


def get_spec(name: str) -> ModelSpec:
    """Look up a preset by name (reference: ModelRegistry pattern matching,
    model_loader.py:466-502)."""
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset '{name}'; available: {sorted(PRESETS)}")
