"""Typed configuration of the PyTorch port.

Counterpart of `memory_augmented_vlm_tpu/config.py`, cut to what the port
runs: the bf16 and int8-serving video paths with the SigLIP tower, the
`mlp2x_gelu` projector, bilinear pooling, the `one_token` merge with an
image newline, the ReLU recurrent memory with the sinusoidal temporal PE,
and a dense SwiGLU Qwen2 LM with RoPE, biased q/k/v and a tied or untied
unembedding. The fields here are the ones the port reads; the JAX config's
other fields select modes the port does not have, and
`convert.config_from_fields` raises `NotImplementedError` when one of them
is set away from its default.

Unlike the JAX config, `VLMConfig.__post_init__` derives `memory.patch_size`
from the SigLIP geometry alone, so importing this module pulls in no tower.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Qwen2 decoder (HF `Qwen2Config` semantics)."""

    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    # read from and written to a checkpoint's config.json (the context length
    # `load_pretrained_model` reports); the port's RoPE does not read it
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    # untied: a separate (H, V) `lm_head` (Qwen2-7B); tied: the embedding table
    tie_word_embeddings: bool = True

    @property
    def kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @staticmethod
    def qwen2_0_5b() -> "LMConfig":
        return LMConfig()

    @staticmethod
    def qwen2_7b() -> "LMConfig":
        return LMConfig(
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            head_dim=128,
            tie_word_embeddings=False,
        )


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """SigLIP-SO400M tower; the last encoder layer is dropped, so the output
    is `hidden_states[-2]`."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    num_channels: int = 3

    @property
    def num_used_layers(self) -> int:
        return self.num_hidden_layers - 1

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Recurrent-memory transformer (hidden size follows the LM)."""

    hidden_size: int = 896
    num_attention_heads: int = 8
    patch_size: int = 196
    layer_norm_eps: float = 1e-12
    intermediate_mult: int = 4
    num_memory_tokens: int = 8
    depth: int = 2
    cache_cap: int = 10
    segment_frames: int = 32
    num_fine_frames: int = 32
    max_temporal_frames: int = 600

    @property
    def intermediate_size(self) -> int:
        return self.intermediate_mult * self.hidden_size


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Multimodal assembly: the pooling stride over the tower's patch grid,
    and whether the tower runs int8 (its weights prequantized by
    `siglip.prequantize_int8`, the serving configuration).

    The image path's fields (`mm_patch_merge_type`, `image_aspect_ratio`,
    `image_grid_pinpoints`) drive `models/image_path.py` and the anyres
    processors; the video path reads none of them. The tokenizer's are
    kept so that an export writes them back."""

    mm_spatial_pool_stride: int = 2
    tower_int8: bool = False
    mm_patch_merge_type: str = "spatial_unpad"
    image_aspect_ratio: str = "anyres_max_9"
    # a spec string or a tuple of (w, h) resolutions (hashable, as the JAX
    # config's)
    image_grid_pinpoints: Union[str, Tuple[Tuple[int, int], ...]] = "(1x1),...,(6x6)"
    tokenizer_model_max_length: int = 32768
    tokenizer_padding_side: str = "right"


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Full model: tower + projector + memory + LM + pipeline."""

    lm: LMConfig = dataclasses.field(default_factory=LMConfig)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)

    def __post_init__(self):
        # tokens per frame after pooling the SigLIP patch grid
        side = self.vision.num_patches_per_side
        stride = self.pipeline.mm_spatial_pool_stride
        pooled = (-(-side // stride)) ** 2 if side > 1 else 1
        memory = dataclasses.replace(self.memory, hidden_size=self.lm.hidden_size,
                                     patch_size=pooled)
        if memory != self.memory:
            object.__setattr__(self, "memory", memory)

    @staticmethod
    def onevision_0_5b() -> "VLMConfig":
        return VLMConfig(lm=LMConfig.qwen2_0_5b())

    @staticmethod
    def onevision_7b() -> "VLMConfig":
        """The memory follows the LM's hidden size: 3584 over 8 heads, a head
        dim of 448."""
        return VLMConfig(lm=LMConfig.qwen2_7b())
