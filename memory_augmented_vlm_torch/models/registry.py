"""Model registry of the port (counterpart of
`memory_augmented_vlm_tpu/models/registry.py`): an HF `config.json`'s
`model_type` and fields -> the port's `LMConfig`.

The port runs the Qwen2 family only (`llava_qwen`, `qwen2`, `qwen`), with
the JAX registry's defaults: a `config.json` that omits
`tie_word_embeddings` gives an untied `lm_head`, and one that omits
`head_dim` gives `hidden_size // num_attention_heads`. Every other family of
the JAX registry (Llama, Mistral, Mixtral, Qwen-MoE, Gemma, MPT) raises
`NotImplementedError`: ROADMAP §1 item 8.
"""

from __future__ import annotations

from memory_augmented_vlm_torch.config import LMConfig

QWEN2_FAMILY = ("qwen", "qwen2", "llava_qwen")

# the JAX registry's other families, which the port does not run yet
UNPORTED_FAMILIES = ("llama", "mistral", "mixtral", "qwen_moe", "qwen2_moe", "gemma", "mpt")


def lm_config_for(model_type: str, raw: dict) -> LMConfig:
    """Map an HF config dict to the port's LMConfig (JAX `lm_config_for`)."""
    family = model_type.replace("llava_", "")
    if family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {model_type!r} is not ported (ROADMAP §1 item 8); the port "
            f"runs {QWEN2_FAMILY}")
    if family not in QWEN2_FAMILY:
        raise ValueError(f"unsupported model family: {model_type}")
    n_heads = raw.get("num_attention_heads", 14)
    return LMConfig(
        vocab_size=raw.get("vocab_size", 151936),
        hidden_size=raw.get("hidden_size", 896),
        intermediate_size=raw.get("intermediate_size", 4864),
        num_hidden_layers=raw.get("num_hidden_layers", 24),
        num_attention_heads=n_heads,
        num_key_value_heads=raw.get("num_key_value_heads", n_heads),
        head_dim=raw.get("head_dim") or raw.get("hidden_size", 896) // n_heads,
        max_position_embeddings=raw.get("max_position_embeddings", 32768),
        rope_theta=raw.get("rope_theta", 1000000.0),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
    )
