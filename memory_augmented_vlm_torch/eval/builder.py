"""Model loading: the public `load_pretrained_model` API of the port
(counterpart of `memory_augmented_vlm_tpu/eval/builder.py`; reference:
llava/model/builder.py:27-305).

Returns the same 4-tuple `(tokenizer, model, image_processor, context_len)`
the lmms-eval `llava_onevision` adapter and the serve and demo entry points
consume. Reads an HF-format LlavaQwen checkpoint directory (`config.json`
and `*.safetensors`, `model.`-prefixed LM keys beside the multimodal ones)
with the port's own safetensors reader, tensor by tensor onto the device.

What the port does not run raises `NotImplementedError` naming its ROADMAP
§1 item: `load_4bit`, the LM families other than Qwen2, the towers other
than SigLIP and the projectors other than `mlp2x_gelu`, and the
`config.json` values that `config_from_json` refuses (item 8).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from memory_augmented_vlm_torch.checkpoint import hf_import
from memory_augmented_vlm_torch.checkpoint.safetensors_io import CheckpointReader
from memory_augmented_vlm_torch.config import MemoryConfig, PipelineConfig, VisionConfig, \
    VLMConfig
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.eval.model import MavlmForCausalLM
from memory_augmented_vlm_torch.models import memory as memory_mod
from memory_augmented_vlm_torch.models import position_encoding
from memory_augmented_vlm_torch.models import projector as projector_mod
from memory_augmented_vlm_torch.models import qwen2, siglip
from memory_augmented_vlm_torch.models.registry import lm_config_for

# files whose presence means the directory carries a tokenizer
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json")

# config.json fields the port runs one value of, which is also the default
# when a config.json omits them (ROADMAP §1 item 8 ports the others)
_ONE_VALUE = {"mm_spatial_pool_mode": "bilinear", "mm_newline_position": "one_token",
              "mm_projector_type": "mlp2x_gelu", "s2": False, "learnable_pe": False}

_MULTIMODAL_PREFIXES = ("model.vision_tower", "model.mm_projector",
                        "model.recurrent_memory_transformer", "model.memory_fuser",
                        "model.token_type_embedding", "model.positional_encoding",
                        "model.image_newline", "model.vision_resampler")
_MEMORY_TAGS = ("recurrent_memory_transformer", "memory_fuser", "token_type_embedding",
                "image_newline")


def _is_siglip(name: str) -> bool:
    name = name.lower()
    return "siglip" in name and not name.startswith("hf:")


def infer_vision_config(sd, tower_name: str = "siglip") -> VisionConfig:
    """The SigLIP tower's geometry from the checkpoint's tensor shapes (JAX
    `infer_vision_config`): hidden and patch size from the patch conv, the
    layers stored (the checkpoint holds the trimmed tower, so one more is
    configured), the image size from the position table. Heads cannot be
    read from the weights: the published towers' counts by hidden size,
    else hidden // 64, at least 1 (a 24-wide tower loads with 1 head,
    whatever its own config said). The image size is the one the tower's
    name publishes where it fits the table (`_image_size`; JAX's differs
    there). Towers other than SigLIP (ImageBind, MLCD, CLIP) are ROADMAP
    §1 item 8."""
    keys = list(sd.keys())
    if "imagebind" in tower_name.lower() or "mlcd" in tower_name.lower() or \
            any(k.endswith("class_pos_emb") for k in keys) or \
            any(k.endswith("embeddings.class_embedding") for k in keys):
        raise NotImplementedError(f"vision tower {tower_name!r} (its weights are not SigLIP's) "
                                  "is not ported (ROADMAP §1 item 8)")
    pe_key = next((k for k in keys if k.endswith("patch_embedding.weight")), None)
    if pe_key is None:
        return VisionConfig()
    hidden, _, patch, _ = sd.shape(pe_key)  # (out, in, kh, kw) torch conv layout
    layers = 1 + max(int(m.group(1)) for k in keys
                     if (m := re.search(r"encoder\.layers\.(\d+)\.", k)))
    inter = sd.shape(next(k for k in keys if k.endswith("layers.0.mlp.fc1.weight")))[0]
    heads = {768: 12, 1024: 16, 1152: 16, 1280: 16, 1408: 16, 1664: 16}.get(
        hidden, max(hidden // 64, 1))
    pos_key = next(k for k in keys if k.endswith("embeddings.position_embedding.weight"))
    side = int(round(sd.shape(pos_key)[0] ** 0.5))
    return VisionConfig(hidden_size=hidden, intermediate_size=inter,
                        num_hidden_layers=layers + 1, num_attention_heads=heads,
                        image_size=_image_size(tower_name, side, patch), patch_size=patch)


def _image_size(tower_name: str, side: int, patch: int) -> int:
    """The tower's input resolution: the one its name publishes
    (`...-patch14-384`) where that gives the position table's side, else
    side * patch. The conv's stride need not divide it: SigLIP-SO400M's
    384 = 27 * 14 + 6 px, which the conv drops. (JAX's builder takes
    side * patch, 378 for that tower, so its processor resizes frames to
    378 where the reference's resizes to 384: ROADMAP §3.)"""
    m = re.search(r"patch(\d+)-(\d+)", tower_name)
    if m and int(m.group(1)) == patch and int(m.group(2)) // patch == side:
        return int(m.group(2))
    return side * patch


def infer_memory_config(sd, lm_hidden: int) -> MemoryConfig:
    """The memory's tokens, patch size and depth from its tensors (JAX
    `infer_memory_config`)."""
    keys = list(sd.keys())
    init_key = next((k for k in keys
                     if k.endswith("recurrent_memory_transformer.initial_memory")), None)
    if init_key is None:
        return MemoryConfig(hidden_size=lm_hidden)
    nm, pp, _ = sd.shape(init_key)
    depth_idx = [int(m.group(1)) for k in keys
                 if (m := re.search(r"recurrent_memory_transformer\.layers\.(\d+)\.", k))]
    depth = 1 + max(depth_idx) if depth_idx else 2
    return MemoryConfig(hidden_size=lm_hidden, num_memory_tokens=nm, patch_size=pp, depth=depth)


def _hashable_pinpoints(pp):
    """config.json stores `image_grid_pinpoints` as a list of [w, h] pairs or
    a spec string; PipelineConfig keeps a hashable value."""
    if isinstance(pp, (list, tuple)):
        return tuple(tuple(int(v) for v in p) for p in pp)
    return pp


def config_from_json(raw: dict) -> VLMConfig:
    """A Llava-family HF config.json -> the port's config (JAX
    `config_from_json`). `model_type` goes through the registry (the Qwen2
    family only). A value the port does not run raises
    `NotImplementedError`: an `mm_spatial_pool_mode` other than bilinear,
    an `mm_newline_position` other than one_token, an `mm_projector_type`
    other than mlp2x_gelu, a non-SigLIP `mm_vision_tower`, `s2`, a
    learnable temporal PE. The image path's fields are kept for
    `models/image_path.py`."""
    lm = lm_config_for(raw.get("model_type", "llava_qwen"), raw)
    for field, ported in _ONE_VALUE.items():
        value = raw.get(field, ported)
        if value != ported:
            raise NotImplementedError(f"{field}={value!r} is not ported (ROADMAP §1 item 8); "
                                      f"the port runs {ported!r}")
    tower = raw.get("mm_vision_tower", "google/siglip-so400m-patch14-384")
    if not _is_siglip(tower):
        raise NotImplementedError(f"mm_vision_tower={tower!r} is not ported (ROADMAP §1 "
                                  "item 8); the port runs SigLIP towers")
    pipeline = PipelineConfig(
        tower_int8=bool(raw.get("tower_int8", False)),
        mm_patch_merge_type=raw.get("mm_patch_merge_type", "spatial_unpad"),
        image_aspect_ratio=raw.get("image_aspect_ratio", "anyres_max_9"),
        image_grid_pinpoints=_hashable_pinpoints(
            raw.get("image_grid_pinpoints", "(1x1),...,(6x6)")),
        tokenizer_model_max_length=raw.get("tokenizer_model_max_length", 32768),
    )
    return VLMConfig(lm=lm, pipeline=pipeline, vision=VisionConfig(),
                     memory=MemoryConfig(hidden_size=lm.hidden_size))


def config_from_json_and_weights(raw: dict, sd) -> VLMConfig:
    """`config_from_json` with the tower's and the memory's geometry read
    from the checkpoint's tensor shapes (`sd`: `keys()` and `shape(name)`)."""
    base = config_from_json(raw)
    tower = raw.get("mm_vision_tower", "google/siglip-so400m-patch14-384")
    return dataclasses.replace(base, vision=infer_vision_config(sd, tower),
                               memory=infer_memory_config(sd, base.lm.hidden_size))


def _device(device_map) -> torch.device:
    """The card, unless the caller asks for the CPU."""
    if device_map == "cpu":
        return torch.device("cpu")
    if device_map == "auto" or (isinstance(device_map, str) and device_map.startswith("cuda")):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: load_pretrained_model puts the params on the "
                               "card; pass device_map='cpu' to load onto the CPU")
        return torch.device("cuda" if device_map == "auto" else device_map)
    raise ValueError(f"device_map {device_map!r}: the port takes 'auto', 'cuda[:n]' or 'cpu'")


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _memory_and_pe(sd: hf_import.Tensors, cfg: VLMConfig, device, dtype) -> dict:
    """The memory's params (converted, or seeded when the checkpoint has
    none, as a plain OneVision checkpoint) and the frozen temporal PE (JAX
    `_memory_and_pe`)."""
    h = cfg.lm.hidden_size
    mem_sd = sd.rename(lambda k: k if any(t in k for t in _MEMORY_TAGS) else None)
    if mem_sd.keys():
        memory = hf_import.convert_memory_modules(mem_sd, cfg.memory.depth)
    else:
        gen = _generator(0, device)

        def lin(d_in, d_out):
            w = torch.randn((d_in, d_out), generator=gen, device=device) * 0.02
            return {"kernel": w.to(dtype), "bias": torch.zeros(d_out, device=device, dtype=dtype)}

        memory = {
            "recurrent_memory_transformer": memory_mod.init_params(cfg.memory, gen, device,
                                                                   dtype),
            "memory_fuser": {"fc1": lin(h, 4 * h), "fc2": lin(4 * h, h)},
            "token_type_embedding": (torch.randn((2, h), generator=gen, device=device)
                                     * 0.02).to(dtype),
        }
    if "image_newline" not in memory:
        newline = np.random.default_rng(0).standard_normal(h).astype(np.float32) / np.sqrt(h)
        memory["image_newline"] = torch.from_numpy(newline).to(device=device, dtype=dtype)
    return {"memory": memory,
            "positional_encoding": position_encoding.init_params(
                cfg.memory.max_temporal_frames, h, device, dtype)}


def _lm_key(k: str) -> Optional[str]:
    """The LM's tensors: `model.`-prefixed, less the multimodal ones, and
    the untied head."""
    if k == "lm_head.weight":
        return k
    if k.startswith("model.") and not k.startswith(_MULTIMODAL_PREFIXES):
        return k[len("model."):]
    return None


def load_params(sd: hf_import.Tensors, cfg: VLMConfig, *, quantize_tower: bool = False,
                quantize_lm: bool = False) -> dict:
    """A checkpoint's tensors -> the port's params on `sd`'s device in its
    dtype. A tower or projector the checkpoint lacks is seeded (the tower
    seed 0, the projector seed 1) at JAX's shapes. `quantize_tower` and
    `quantize_lm` prequantize the tower and the LM (its unembedding stays
    float) to int8."""
    device, dtype = sd.device, sd.dtype
    tower_sd = sd.rename(lambda k: k[len("model."):] if k.startswith("model.vision_tower")
                         else None)
    if tower_sd.keys():
        tower = hf_import.convert_siglip(tower_sd, cfg.vision)
    else:  # the reference pulls a missing tower from the hub; offline it is seeded
        tower = siglip.init_params(cfg.vision, _generator(0, device), device, dtype)
    if any("mm_projector" in k for k in sd.keys()):
        projector = hf_import.convert_projector(sd)
    else:
        projector = projector_mod.init_params(cfg.vision.hidden_size, cfg.lm.hidden_size,
                                              _generator(1, device), device, dtype)
    params = {"language_model": hf_import.convert_qwen2(sd.rename(_lm_key), cfg.lm),
              "vision_tower": tower, "mm_projector": projector,
              **_memory_and_pe(sd, cfg, device, dtype)}
    if quantize_tower:
        params["vision_tower"] = siglip.prequantize_int8(params["vision_tower"])
    if quantize_lm:
        params["language_model"] = qwen2.prequantize_int8(params["language_model"])
    return params


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    torch_dtype="bfloat16",
    attn_implementation: str = "flash",  # accepted for signature parity
    device_map="auto",
    load_8bit: bool = False,
    load_4bit: bool = False,
    overwrite_config: Optional[dict] = None,
    device_preprocess: bool = False,
    **kwargs,
) -> Tuple[object, MavlmForCausalLM, SigLipImageProcessor, int]:
    """Load an HF-format checkpoint directory into the port's model, on the
    card unless `device_map="cpu"` (without a card, anything else raises).

    builder.py:27-305's contract: `overwrite_config` entries override
    config.json fields (this is how lmms-eval passes `max_frames_num` and
    others); `torch_dtype` "bfloat16" or "auto" loads bf16, anything else
    fp32; `load_8bit` prequantizes the tower and the LM to int8 (the LM's
    unembedding stays float); the tokenizer loads where the directory holds
    tokenizer files (its errors raise), else it is None; context_len is
    max_sequence_length, max_position_embeddings,
    tokenizer_model_max_length or 2048, the first one config.json has.
    `device_preprocess` has the model resize and normalize raw uint8 frames
    and images on the card (`ops/preprocess.py`) instead of the host
    processor. `model_base` is accepted and not read, as JAX's builder
    takes it (`model_vqa --model-base` passes it through)."""
    if load_4bit:
        raise NotImplementedError("load_4bit is not ported (ROADMAP §1 item 8)")
    device = _device(device_map)
    with open(os.path.join(model_path, "config.json")) as f:
        raw = json.load(f)
    if overwrite_config:
        raw.update(overwrite_config)
    if load_8bit:
        raw["tower_int8"] = True
        raw["lm_int8"] = True
    dtype = torch.bfloat16 if torch_dtype in ("bfloat16", "auto", torch.bfloat16) \
        else torch.float32
    with CheckpointReader(model_path) as reader:
        cfg = config_from_json_and_weights(raw, reader)
        params = load_params(hf_import.Tensors(reader, device, dtype), cfg,
                             quantize_tower=cfg.pipeline.tower_int8,
                             quantize_lm=bool(raw.get("lm_int8")))
    tokenizer = None
    if any(os.path.exists(os.path.join(model_path, f)) for f in TOKENIZER_FILES):
        from memory_augmented_vlm_torch.data.tokenizer import load_qwen_tokenizer

        tokenizer = load_qwen_tokenizer(model_path)
    image_processor = SigLipImageProcessor(size=(cfg.vision.image_size, cfg.vision.image_size))
    model = MavlmForCausalLM(params, cfg, raw_config=raw, dtype=dtype,
                             device_preprocess=device_preprocess)
    context_len = (raw.get("max_sequence_length") or raw.get("max_position_embeddings")
                   or raw.get("tokenizer_model_max_length") or 2048)
    return tokenizer, model, image_processor, context_len
