"""HF checkpoint → JAX pytree conversion and model registry.

Replaces the reference's loader stack (/root/reference/baseline/
model_loader.py:14-510: BaseModelLoader, HuggingFaceModelLoader,
CustomModelLoader, regex ModelRegistry). The difference: instead
of keeping a live torch module and mutating it, we convert the weights ONCE
into this framework's stacked-layer pytree (models/transformer.py) and the
torch object is never touched again. Works fully offline from a local
directory (safetensors / pytorch_model.bin) or from an in-memory
``transformers`` model (used by the parity tests).
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import jax.numpy as jnp

from mlio_tpu.models.spec import ModelSpec, PRESETS, get_spec

StateDict = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# State-dict acquisition (offline)
# ---------------------------------------------------------------------------

def state_dict_from_torch(model) -> StateDict:
    """Pull a numpy state dict out of a live torch module (no copy of the
    framework keeps the torch object alive)."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def state_dict_from_dir(path: Path) -> StateDict:
    """Load all weights from a local HF checkpoint directory."""
    path = Path(path)
    sd: StateDict = {}
    safetensor_files = sorted(path.glob("*.safetensors"))
    if safetensor_files:
        from safetensors.numpy import load_file

        for f in safetensor_files:
            sd.update(load_file(str(f)))
        return sd
    bin_files = sorted(path.glob("pytorch_model*.bin")) + sorted(path.glob("*.pt"))
    if bin_files:
        import torch

        for f in bin_files:
            loaded = torch.load(f, map_location="cpu", weights_only=True)
            if hasattr(loaded, "state_dict"):
                loaded = loaded.state_dict()
            sd.update({k: v.numpy() for k, v in loaded.items()})
        return sd
    raise FileNotFoundError(f"no weights (*.safetensors / pytorch_model*.bin) in {path}")


# ---------------------------------------------------------------------------
# Spec derivation from HF config
# ---------------------------------------------------------------------------

def spec_from_hf_config(cfg: Any, name: str = "custom") -> ModelSpec:
    """Derive a ModelSpec from an HF config object or dict (parity:
    get_model_config model_loader.py:156-254)."""
    get = (lambda k, d=None: cfg.get(k, d)) if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    model_type = get("model_type", "gpt2")
    if model_type == "gpt2":
        h = get("n_embd")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=h,
            num_layers=get("n_layer"), num_heads=get("n_head"),
            num_kv_heads=get("n_head"),
            intermediate_size=get("n_inner") or 4 * h,
            max_seq_len=get("n_positions", 1024),
            activation="gelu_new", norm="layernorm",
            norm_eps=get("layer_norm_epsilon", 1e-5),
            positional="learned", tie_embeddings=True)
    if model_type == "mixtral":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 8192),
            activation="swiglu", norm="rmsnorm",
            norm_eps=get("rms_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rope_theta", 1000000.0),
            use_qkv_bias=False, use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            num_experts=get("num_local_experts", 8),
            num_experts_per_tok=get("num_experts_per_tok", 2))
    if model_type in ("llama", "mistral", "qwen2"):
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 4096),
            activation="swiglu", norm="rmsnorm",
            norm_eps=get("rms_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            # Qwen2 carries biases on Q/K/V only
            use_qkv_bias=(model_type == "qwen2"),
            use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=bool(get("tie_word_embeddings", False)))
    if model_type == "gemma":
        heads = get("num_attention_heads")
        h = get("hidden_size")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=h,
            num_layers=get("num_hidden_layers"), num_heads=heads,
            num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 8192),
            head_dim=get("head_dim"),
            activation="geglu", norm="rmsnorm",
            norm_eps=get("rms_norm_eps", 1e-6), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            use_qkv_bias=False, use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=True, embed_scale=float(h) ** 0.5)
    if model_type == "gpt_neox":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="gelu", norm="layernorm",
            norm_eps=get("layer_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rotary_emb_base", 10000.0),
            rope_fraction=get("rotary_pct", 0.25),
            use_qkv_bias=True, use_mlp_bias=True, use_out_bias=True,
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            parallel_residual=bool(get("use_parallel_residual", True)))
    if model_type == "phi":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="gelu_new", norm="layernorm",
            norm_eps=get("layer_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            rope_fraction=get("partial_rotary_factor", 0.5),
            use_qkv_bias=True, use_mlp_bias=True, use_out_bias=True,
            tie_embeddings=False, use_head_bias=True,
            parallel_residual=True, shared_ln=True)
    if model_type == "opt":
        h = get("hidden_size")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=h,
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_attention_heads"),
            intermediate_size=get("ffn_dim", 4 * h),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="relu", norm="layernorm", norm_eps=1e-5,
            positional="learned", tie_embeddings=True)
    raise ValueError(f"unsupported HF model_type '{model_type}'")


# ---------------------------------------------------------------------------
# Conversion (per architecture family)
# ---------------------------------------------------------------------------

def _stack(sd: StateDict, fmt: str, num_layers: int, transform=None) -> Optional[jnp.ndarray]:
    key0 = fmt.format(0)
    if key0 not in sd:
        return None
    arrs = []
    for i in range(num_layers):
        a = np.asarray(sd[fmt.format(i)])
        if transform is not None:
            a = transform(a)
        arrs.append(a)
    return jnp.asarray(np.stack(arrs))


def convert_gpt2(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """GPT-2 state dict → pytree. HF GPT-2 uses Conv1D ([in, out] weight
    layout — matches ours directly) with a fused c_attn [H, 3H] that we split
    into q/k/v (the split the reference does at conversion time,
    flash_attention.py:1050-1110)."""
    # Keys may or may not carry the "transformer." prefix.
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L, H = spec.num_layers, spec.hidden_size

    def g(key):
        return np.asarray(sd[prefix + key])

    def stack(fmt, transform=None):
        return _stack({k: v for k, v in sd.items()}, prefix + fmt, L, transform)

    qkv_w = np.stack([g(f"h.{i}.attn.c_attn.weight") for i in range(L)])  # [L, H, 3H]
    qkv_b = np.stack([g(f"h.{i}.attn.c_attn.bias") for i in range(L)])  # [L, 3H]
    wq, wk, wv = np.split(qkv_w, 3, axis=2)
    bq, bk, bv = np.split(qkv_b, 3, axis=1)

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    blocks = {
        "ln1_scale": J(np.stack([g(f"h.{i}.ln_1.weight") for i in range(L)])),
        "ln1_bias": J(np.stack([g(f"h.{i}.ln_1.bias") for i in range(L)])),
        "wq": J(wq), "bq": J(bq), "wk": J(wk), "bk": J(bk), "wv": J(wv), "bv": J(bv),
        "wo": J(np.stack([g(f"h.{i}.attn.c_proj.weight") for i in range(L)])),
        "bo": J(np.stack([g(f"h.{i}.attn.c_proj.bias") for i in range(L)])),
        "ln2_scale": J(np.stack([g(f"h.{i}.ln_2.weight") for i in range(L)])),
        "ln2_bias": J(np.stack([g(f"h.{i}.ln_2.bias") for i in range(L)])),
        "w_up": J(np.stack([g(f"h.{i}.mlp.c_fc.weight") for i in range(L)])),
        "b_up": J(np.stack([g(f"h.{i}.mlp.c_fc.bias") for i in range(L)])),
        "w_gate": None, "b_gate": None,
        "w_down": J(np.stack([g(f"h.{i}.mlp.c_proj.weight") for i in range(L)])),
        "b_down": J(np.stack([g(f"h.{i}.mlp.c_proj.bias") for i in range(L)])),
    }
    return {
        "tok_embed": J(g("wte.weight")),
        "pos_embed": J(g("wpe.weight")),
        "blocks": blocks,
        "final_scale": J(g("ln_f.weight")),
        "final_bias": J(g("ln_f.bias")),
        "lm_head": None,  # GPT-2 ties lm_head to wte
    }


def convert_llama(sd: StateDict, spec: ModelSpec, dtype=jnp.float32,
                  norm_offset: float = 0.0) -> Dict[str, Any]:
    """Llama/Mistral/Qwen2/Gemma state dict → pytree. torch Linear stores
    [out, in]; we transpose to [in, out] once here so the forward is a plain
    x @ W. Optional Q/K/V biases (Qwen2) are picked up when present;
    ``norm_offset=1`` folds Gemma's (1 + w) RMSNorm weights at conversion."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L = spec.num_layers

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def lin(fmt):
        return J(np.stack([g(fmt.format(i)).T for i in range(L)]))

    def bias(fmt):
        if prefix + fmt.format(0) not in sd:
            return None
        return J(np.stack([g(fmt.format(i)) for i in range(L)]))

    def ln(fmt):
        return J(np.stack([g(fmt.format(i)) for i in range(L)]) + norm_offset)

    blocks = {
        "ln1_scale": ln("layers.{}.input_layernorm.weight"),
        "ln1_bias": None,
        "wq": lin("layers.{}.self_attn.q_proj.weight"),
        "bq": bias("layers.{}.self_attn.q_proj.bias"),
        "wk": lin("layers.{}.self_attn.k_proj.weight"),
        "bk": bias("layers.{}.self_attn.k_proj.bias"),
        "wv": lin("layers.{}.self_attn.v_proj.weight"),
        "bv": bias("layers.{}.self_attn.v_proj.bias"),
        "wo": lin("layers.{}.self_attn.o_proj.weight"),
        "bo": None,
        "ln2_scale": ln("layers.{}.post_attention_layernorm.weight"),
        "ln2_bias": None,
        "w_up": lin("layers.{}.mlp.up_proj.weight"),
        "b_up": None,
        "w_gate": lin("layers.{}.mlp.gate_proj.weight"),
        "b_gate": None,
        "w_down": lin("layers.{}.mlp.down_proj.weight"),
        "b_down": None,
    }
    if spec.tie_embeddings or "lm_head.weight" not in sd:
        lm_head = None
    else:
        lm_head = J(np.asarray(sd["lm_head.weight"]).T)
    return {
        "tok_embed": J(g("embed_tokens.weight")),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": J(g("norm.weight") + norm_offset),
        "final_bias": None,
        "lm_head": lm_head,
    }


def convert_mixtral(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """Mixtral state dict → pytree: Llama attention + sparse-MoE MLP.

    HF layout per layer: ``block_sparse_moe.gate.weight`` [E, h] router and
    per-expert ``experts.{e}.w1/w3/w2.weight`` (w1 = SwiGLU gate, w3 = up,
    w2 = down). Experts stack onto a leading E axis so the forward's grouped
    matmul (ops/moe.py) sees [L, E, h, i] / [L, E, i, h]."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L, E = spec.num_layers, spec.num_experts

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def expert_stack(w: str):
        # [L, E, in, out] from torch's [out, in] per expert
        return J(np.stack([
            np.stack([g(f"layers.{i}.block_sparse_moe.experts.{e}.{w}.weight").T
                      for e in range(E)]) for i in range(L)]))

    params = convert_llama_attention_only(sd, spec, dtype)
    params["blocks"].update({
        "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
        "w_down": None, "b_down": None,
        "router": J(np.stack(
            [g(f"layers.{i}.block_sparse_moe.gate.weight").T
             for i in range(L)])),
        "moe_gate": expert_stack("w1"),
        "moe_up": expert_stack("w3"),
        "moe_down": expert_stack("w2"),
    })
    return params


def convert_llama_attention_only(sd: StateDict, spec: ModelSpec,
                                 dtype=jnp.float32) -> Dict[str, Any]:
    """Llama-layout conversion skipping the dense-MLP keys (for MoE models
    whose attention/norm/embedding layout matches Llama)."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L = spec.num_layers

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def lin(fmt):
        return J(np.stack([g(fmt.format(i)).T for i in range(L)]))

    def ln(fmt):
        return J(np.stack([g(fmt.format(i)) for i in range(L)]))

    blocks = {
        "ln1_scale": ln("layers.{}.input_layernorm.weight"),
        "ln1_bias": None,
        "wq": lin("layers.{}.self_attn.q_proj.weight"), "bq": None,
        "wk": lin("layers.{}.self_attn.k_proj.weight"), "bk": None,
        "wv": lin("layers.{}.self_attn.v_proj.weight"), "bv": None,
        "wo": lin("layers.{}.self_attn.o_proj.weight"), "bo": None,
        "ln2_scale": ln("layers.{}.post_attention_layernorm.weight"),
        "ln2_bias": None,
    }
    lm_head = (None if spec.tie_embeddings or "lm_head.weight" not in sd
               else J(np.asarray(sd["lm_head.weight"]).T))
    return {
        "tok_embed": J(g("embed_tokens.weight")),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": J(g("norm.weight")),
        "final_bias": None,
        "lm_head": lm_head,
    }


def convert_gemma(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """Gemma = Llama layout + (1 + w) RMSNorm (folded here) + GeGLU +
    sqrt(hidden) embedding scale (a spec knob, not a weight transform)."""
    return convert_llama(sd, spec, dtype=dtype, norm_offset=1.0)


def convert_gpt_neox(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """GPT-NeoX/Pythia state dict → pytree: per-head-packed fused QKV
    ([heads, (q|k|v), head_dim] row order) is unpacked here; parallel
    residual and partial rotary are spec knobs."""
    prefix = "gpt_neox." if any(k.startswith("gpt_neox.") for k in sd) else ""
    L, H = spec.num_layers, spec.hidden_size
    heads, hd = spec.num_heads, spec.head_size

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def lin(fmt):
        return J(np.stack([g(fmt.format(i)).T for i in range(L)]))

    def vec(fmt):
        return J(np.stack([g(fmt.format(i)) for i in range(L)]))

    wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
    for i in range(L):
        w = g(f"layers.{i}.attention.query_key_value.weight")  # [3H, H]
        b = g(f"layers.{i}.attention.query_key_value.bias")    # [3H]
        w = w.reshape(heads, 3, hd, H)
        b = b.reshape(heads, 3, hd)
        wq.append(w[:, 0].reshape(heads * hd, H).T)
        wk.append(w[:, 1].reshape(heads * hd, H).T)
        wv.append(w[:, 2].reshape(heads * hd, H).T)
        bq.append(b[:, 0].reshape(-1))
        bk.append(b[:, 1].reshape(-1))
        bv.append(b[:, 2].reshape(-1))

    blocks = {
        "ln1_scale": vec("layers.{}.input_layernorm.weight"),
        "ln1_bias": vec("layers.{}.input_layernorm.bias"),
        "wq": J(np.stack(wq)), "bq": J(np.stack(bq)),
        "wk": J(np.stack(wk)), "bk": J(np.stack(bk)),
        "wv": J(np.stack(wv)), "bv": J(np.stack(bv)),
        "wo": lin("layers.{}.attention.dense.weight"),
        "bo": vec("layers.{}.attention.dense.bias"),
        "ln2_scale": vec("layers.{}.post_attention_layernorm.weight"),
        "ln2_bias": vec("layers.{}.post_attention_layernorm.bias"),
        "w_up": lin("layers.{}.mlp.dense_h_to_4h.weight"),
        "b_up": vec("layers.{}.mlp.dense_h_to_4h.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": lin("layers.{}.mlp.dense_4h_to_h.weight"),
        "b_down": vec("layers.{}.mlp.dense_4h_to_h.bias"),
    }
    return {
        "tok_embed": J(g("embed_in.weight")),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": J(g("final_layer_norm.weight")),
        "final_bias": J(g("final_layer_norm.bias")),
        "lm_head": J(np.asarray(sd["embed_out.weight"]).T),
    }


def convert_phi(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """Phi-1/1.5/2 state dict → pytree: one shared LayerNorm feeds both
    parallel branches (spec.shared_ln); lm_head carries a bias."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L = spec.num_layers

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def lin(fmt):
        return J(np.stack([g(fmt.format(i)).T for i in range(L)]))

    def vec(fmt):
        return J(np.stack([g(fmt.format(i)) for i in range(L)]))

    ln_scale = vec("layers.{}.input_layernorm.weight")
    ln_bias = vec("layers.{}.input_layernorm.bias")
    blocks = {
        "ln1_scale": ln_scale, "ln1_bias": ln_bias,
        "wq": lin("layers.{}.self_attn.q_proj.weight"),
        "bq": vec("layers.{}.self_attn.q_proj.bias"),
        "wk": lin("layers.{}.self_attn.k_proj.weight"),
        "bk": vec("layers.{}.self_attn.k_proj.bias"),
        "wv": lin("layers.{}.self_attn.v_proj.weight"),
        "bv": vec("layers.{}.self_attn.v_proj.bias"),
        "wo": lin("layers.{}.self_attn.dense.weight"),
        "bo": vec("layers.{}.self_attn.dense.bias"),
        # shared LN: ln2 slots duplicate ln1 to keep the pytree uniform
        # (unused by the shared_ln forward path).
        "ln2_scale": ln_scale, "ln2_bias": ln_bias,
        "w_up": lin("layers.{}.mlp.fc1.weight"),
        "b_up": vec("layers.{}.mlp.fc1.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": lin("layers.{}.mlp.fc2.weight"),
        "b_down": vec("layers.{}.mlp.fc2.bias"),
    }
    return {
        "tok_embed": J(g("embed_tokens.weight")),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": J(g("final_layernorm.weight")),
        "final_bias": J(g("final_layernorm.bias")),
        "lm_head": J(np.asarray(sd["lm_head.weight"]).T),
        "lm_head_bias": J(np.asarray(sd["lm_head.bias"])),
    }


def convert_opt(sd: StateDict, spec: ModelSpec, dtype=jnp.float32) -> Dict[str, Any]:
    """OPT state dict → pytree. The learned position table's +2 offset
    (OPTLearnedPositionalEmbedding) is folded by dropping its first two rows.
    Pre-LN variants only (do_layer_norm_before=True)."""
    prefix = next((p for p in ("model.decoder.", "decoder.")
                   if any(k.startswith(p) for k in sd)), "")
    L = spec.num_layers

    def g(key):
        return np.asarray(sd[prefix + key])

    def J(x):
        return jnp.asarray(x, dtype=dtype)

    def lin(fmt):
        return J(np.stack([g(fmt.format(i)).T for i in range(L)]))

    def vec(fmt):
        return J(np.stack([g(fmt.format(i)) for i in range(L)]))

    blocks = {
        "ln1_scale": vec("layers.{}.self_attn_layer_norm.weight"),
        "ln1_bias": vec("layers.{}.self_attn_layer_norm.bias"),
        "wq": lin("layers.{}.self_attn.q_proj.weight"),
        "bq": vec("layers.{}.self_attn.q_proj.bias"),
        "wk": lin("layers.{}.self_attn.k_proj.weight"),
        "bk": vec("layers.{}.self_attn.k_proj.bias"),
        "wv": lin("layers.{}.self_attn.v_proj.weight"),
        "bv": vec("layers.{}.self_attn.v_proj.bias"),
        "wo": lin("layers.{}.self_attn.out_proj.weight"),
        "bo": vec("layers.{}.self_attn.out_proj.bias"),
        "ln2_scale": vec("layers.{}.final_layer_norm.weight"),
        "ln2_bias": vec("layers.{}.final_layer_norm.bias"),
        "w_up": lin("layers.{}.fc1.weight"),
        "b_up": vec("layers.{}.fc1.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": lin("layers.{}.fc2.weight"),
        "b_down": vec("layers.{}.fc2.bias"),
    }
    return {
        "tok_embed": J(g("embed_tokens.weight")),
        "pos_embed": J(g("embed_positions.weight")[2:]),
        "blocks": blocks,
        "final_scale": J(g("final_layer_norm.weight")),
        "final_bias": J(g("final_layer_norm.bias")),
        "lm_head": None,  # tied
    }


# ---------------------------------------------------------------------------
# Registry (parity: ModelRegistry model_loader.py:466-502)
# ---------------------------------------------------------------------------

class ModelRegistry:
    """Regex-pattern registry mapping model names to converters."""

    def __init__(self):
        self._entries = []  # (pattern, converter)

    def register(self, pattern: str, converter: Callable):
        self._entries.append((re.compile(pattern), converter))

    def get_converter(self, name: str) -> Callable:
        for pattern, conv in self._entries:
            if pattern.match(name):
                return conv
        raise KeyError(f"no converter registered for model '{name}'")


model_registry = ModelRegistry()
model_registry.register(r"gpt2.*", convert_gpt2)
model_registry.register(r".*mixtral.*", convert_mixtral)
model_registry.register(r".*llama.*", convert_llama)
model_registry.register(r".*mistral.*", convert_llama)
model_registry.register(r".*qwen.*", convert_llama)
model_registry.register(r".*gemma.*", convert_gemma)
model_registry.register(r".*(neox|pythia).*", convert_gpt_neox)
model_registry.register(r".*phi.*", convert_phi)
model_registry.register(r".*opt.*", convert_opt)


def load_model(
    name_or_path: str,
    *,
    dtype=jnp.bfloat16,
    torch_model=None,
    spec: Optional[ModelSpec] = None,
    seed: int = 0,
):
    """Load a model by preset name, local checkpoint dir, or torch module.

    Returns ``(spec, params)``. Parity: load_model model_loader.py:466-510
    minus the network path (checkpoints must be local). A preset name with
    no checkpoint gets random weights from ``seed``, created on the device
    under jit.
    """
    path = Path(name_or_path)
    if torch_model is not None:
        sd = state_dict_from_torch(torch_model)
        if spec is None:
            spec = spec_from_hf_config(torch_model.config, name=name_or_path)
    elif path.is_dir():
        sd = state_dict_from_dir(path)
        cfg_file = path / "config.json"
        if spec is None:
            if not cfg_file.exists():
                raise FileNotFoundError(f"no config.json in {path}; pass spec=")
            spec = spec_from_hf_config(json.loads(cfg_file.read_text()),
                                       name=path.name)
    else:
        # Preset name without weights → random init (useful for benchmarks).
        import jax

        from mlio_tpu.parallel.tensor_parallel import init_sharded_params

        spec = spec or get_spec(name_or_path)
        return spec, init_sharded_params(spec, jax.random.PRNGKey(seed),
                                         dtype)

    try:
        converter = model_registry.get_converter(name_or_path)
    except KeyError:
        # Fall back on architecture: learned positions + LayerNorm = GPT-2
        # family layout, otherwise the Llama-style layout.
        converter = convert_gpt2 if spec.positional == "learned" else convert_llama
    params = converter(sd, spec, dtype=dtype)
    return spec, params
