"""The port's checkpoint modules against the `safetensors` package and the
JAX package, on the CPU at tiny sizes.

- `checkpoint/safetensors_io.py` against the `safetensors` package in both
  directions (every dtype a checkpoint holds, bf16 kept bf16, int8,
  `__metadata__`) and a sharded directory through
  `model.safetensors.index.json` against JAX's `load_safetensors_dir`:
  equal bit for bit.
- `checkpoint/hf_import.py`: each converter against
  `convert.from_jax_params` of JAX's converter on the same HF tensors, leaf
  for leaf and bit for bit, fp32 and bf16, with and without q/k/v biases
  and an untied head.
- `checkpoint/checkpoint_io.py`: the port's export read back by JAX's
  `load_pretrained_model` and JAX's export by the port's, params equal
  both ways; the same `config.json`; int8 entries written dequantized
  (within 1e-6 relative of JAX's, whose scales may differ by an ulp); the
  train state's save and restore (bit-equal, `block` True and False,
  `keep`, `latest_checkpoint`).
- `checkpoint/delta.py` and `models/tokenizer_init.py` against JAX's:
  equal, but the mean rows of a resized table (summed in another order:
  within 1e-8 absolute).
"""

import json
import os

import numpy as np
import jax
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from memory_augmented_vlm_tpu.checkpoint import delta as jdelta
from memory_augmented_vlm_tpu.checkpoint import hf_import as jhf
from memory_augmented_vlm_tpu.checkpoint import orbax_io as jorbax
from memory_augmented_vlm_tpu.eval.builder import load_pretrained_model as jload
from memory_augmented_vlm_tpu.models import tokenizer_init as jtok_init
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.checkpoint import checkpoint_io, hf_import, safetensors_io
from memory_augmented_vlm_torch.checkpoint import delta as tdelta
from memory_augmented_vlm_torch.eval.builder import config_from_json_and_weights
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model as tload
from memory_augmented_vlm_torch.models import qwen2 as tqwen2
from memory_augmented_vlm_torch.models import siglip as tsiglip
from memory_augmented_vlm_torch.models import tokenizer_init as ttok_init
from memory_augmented_vlm_torch.models import vlm as tvlm
from memory_augmented_vlm_torch.train import optimizer as toptimizer
from memory_augmented_vlm_torch.train import trainer as ttrainer
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str
from test_builder_roundtrip import ckpt_dir  # noqa: F401  (the tiny checkpoint)
from test_vlm import TINY

# a mean row of a resized table, summed in another order than numpy's: the
# means of the tests' N(0, 0.02) and N(0, 1) tables sit near 0, so the bound
# is absolute (1.1e-9 seen)
MEAN_ATOL = 1e-8
# an int8 entry dequantized, whose scale may differ from JAX's by an ulp
DEQUANT_RTOL = 1e-6


def assert_trees_equal(got, want, what=""):
    """Same paths, shapes, dtypes and bits."""
    a, b = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert a.keys() == b.keys(), (what, sorted(map(path_str, set(a) ^ set(b))))
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, path_str(k), a[k].dtype, b[k].dtype)
        assert torch.equal(a[k], b[k]), (what, path_str(k))


def _port_of_jax(jparams, cfg, dtype=None):
    return convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                                   dtype=dtype)


# ------------------------------------------------------------ safetensors

def _all_dtypes(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(4, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-127, 128, (6, 5), generator=g, dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (3,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (2, 2), generator=g, dtype=torch.int64),
        "u8": torch.randint(0, 256, (7,), generator=g, dtype=torch.uint8),
        "bool": torch.rand(5, generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_reader_reads_the_package_bit_for_bit(tmp_path):
    tensors = _all_dtypes()
    path = str(tmp_path / "a.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    with safetensors_io.SafetensorsFile(path) as f:
        assert f.metadata == {"format": "pt", "note": "x"}
        assert sorted(f.keys()) == sorted(tensors)
        for name, want in tensors.items():
            got = f.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got, want), name
            assert f.shape(name) == tuple(want.shape)


def test_package_reads_the_writer_bit_for_bit(tmp_path):
    tensors = _all_dtypes(1)
    tensors["col_major_i8"] = tensors["i8"].t().contiguous().t()  # any layout is written
    path = str(tmp_path / "b.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    got = st_load_file(path)
    assert got.keys() == tensors.keys()
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype and torch.equal(got[name], want), name
    with safe_open(path, framework="np") as f:
        assert f.metadata() == {"format": "pt"}
        np.testing.assert_array_equal(f.get_tensor("f32"), tensors["f32"].numpy())
    assert not os.path.exists(path + ".tmp")


def test_writer_casts_as_it_writes(tmp_path):
    t = {"w": torch.randn(4, 3, dtype=torch.float64), "b": torch.randn(3).bfloat16()}
    path = str(tmp_path / "c.safetensors")
    safetensors_io.save_file(t, path, dtype=torch.float32)
    got = st_load_file(path)
    assert got["w"].dtype == got["b"].dtype == torch.float32
    assert torch.equal(got["w"], t["w"].float()) and torch.equal(got["b"], t["b"].float())


def test_reader_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x01")
    with pytest.raises(ValueError, match="too short"):
        safetensors_io.SafetensorsFile(str(bad))
    path = str(tmp_path / "trunc.safetensors")
    st_save_file({"x": torch.zeros(16)}, path)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-4])
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.SafetensorsFile(path)


def test_a_tensor_outlives_its_file(tmp_path):
    path = str(tmp_path / "d.safetensors")
    st_save_file({"x": torch.arange(10, dtype=torch.float32)}, path)
    f = safetensors_io.SafetensorsFile(path)
    x = f.get("x")
    f.close()
    del f
    assert torch.equal(x, torch.arange(10, dtype=torch.float32))


def test_sharded_directory_against_jax(tmp_path):
    rng = np.random.default_rng(0)
    shards = [{"model.a": rng.standard_normal((3, 4)).astype(np.float32),
               "model.b": rng.standard_normal(5).astype(np.float32)},
              {"lm_head.weight": rng.standard_normal((6, 4)).astype(np.float32)}]
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        np_save_file(shard, str(tmp_path / name))
        weight_map.update(dict.fromkeys(shard, name))
    # a stray file the index does not name is not read
    np_save_file({"stray": np.zeros(2, np.float32)}, str(tmp_path / "stray.safetensors"))
    with open(tmp_path / safetensors_io.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    want = jhf.load_safetensors_dir(str(tmp_path))
    with safetensors_io.CheckpointReader(str(tmp_path)) as reader:
        assert sorted(reader.keys()) == sorted(want) == ["lm_head.weight", "model.a", "model.b"]
        for name in want:
            np.testing.assert_array_equal(reader.get(name).numpy(), want[name])
            assert reader.shape(name) == want[name].shape


def test_unsharded_directory_reads_bf16_as_bf16(tmp_path):
    t = torch.randn(4, 4).bfloat16()
    st_save_file({"w": t}, str(tmp_path / "model.safetensors"))
    with safetensors_io.CheckpointReader(str(tmp_path)) as reader:
        got = reader.get("w")
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    # JAX's reader upcasts the same bits to fp32
    np.testing.assert_array_equal(jhf.load_safetensors_dir(str(tmp_path))["w"],
                                  t.float().numpy())


# ------------------------------------------------------------- converters

@pytest.fixture(scope="module")
def hf_state(ckpt_dir):  # noqa: F811
    """The tiny checkpoint's tensors (numpy fp32, as JAX reads them) and its
    config.json."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        raw = json.load(f)
    return jhf.load_safetensors_dir(ckpt_dir), raw


def _variant(sd, raw, variant):
    """The checkpoint as it is, or with its LM tied (no lm_head) and
    without q/k/v biases."""
    if variant == "as_saved":
        return sd, raw
    sd = {k: v for k, v in sd.items()
          if k != "lm_head.weight" and not (".self_attn." in k and k.endswith(".bias")
                                              and k.startswith("model.layers."))}
    return sd, dict(raw, tie_word_embeddings=True)


_MEMORY_TAGS = ("recurrent_memory_transformer", "memory_fuser", "token_type_embedding",
                "image_newline")


def _parts(sd):
    """The checkpoint's tensors as the JAX builder hands them to each
    converter."""
    lm = {k[len("model."):]: v for k, v in sd.items()
          if k.startswith("model.") and not k.startswith(("model.vision_tower", "model.mm_projector"))
          and not any(t in k for t in _MEMORY_TAGS)}
    if "lm_head.weight" in sd:
        lm["lm_head.weight"] = sd["lm_head.weight"]
    return {"language_model": lm,
            "vision_tower": {k[len("model."):]: v for k, v in sd.items()
                             if k.startswith("model.vision_tower")},
            "mm_projector": sd,
            "memory": {k: v for k, v in sd.items() if any(t in k for t in _MEMORY_TAGS)}}


def _convert(conv, parts, cfg):
    """Each module's converter of one package over its part."""
    return {"language_model": conv.convert_qwen2(parts["language_model"], cfg.lm),
            "vision_tower": conv.convert_siglip(parts["vision_tower"], cfg.vision),
            "mm_projector": conv.convert_projector(parts["mm_projector"], "mlp2x_gelu"),
            "memory": conv.convert_memory_modules(parts["memory"], cfg.memory.depth)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["as_saved", "tied_no_bias"])
def test_converters_match_jax_leaf_for_leaf(hf_state, variant, dtype):
    from memory_augmented_vlm_tpu.eval.builder import config_from_json_and_weights as jcfg

    sd, raw = _variant(*hf_state, variant)
    parts = _parts(sd)
    jtree = _convert(jhf, parts, jcfg(raw, sd))
    jtree["positional_encoding"] = {"frame_embed": np.zeros((1, 1), np.float32)}
    cfg = config_from_json_and_weights(raw, hf_import.Tensors(sd))
    want = convert.from_jax_params(jtree, cfg, device="cpu", dtype=dtype)
    got = _convert(hf_import, {k: hf_import.Tensors(
        {n: torch.from_numpy(v) for n, v in part.items()}, "cpu", dtype)
        for k, part in parts.items()}, cfg)
    for key, tree in got.items():
        assert_trees_equal(tree, want[key], key)
    lm = got["language_model"]
    assert ("lm_head" in lm) == (variant == "as_saved")
    assert ("bias" in lm["layers"][0]["q_proj"]) == (variant == "as_saved")
    assert got["vision_tower"]["patch_embedding"]["weight"].shape == (24, 3, 14, 14)


def test_converter_reads_bare_keys(hf_state):
    """Keys without the `model.` prefix (a bare HF Qwen2 / SigLIP state
    dict) convert the same."""
    sd, raw = hf_state
    cfg = config_from_json_and_weights(raw, hf_import.Tensors(sd))
    prefixed = hf_import.Tensors({k: torch.from_numpy(v) for k, v in sd.items()
                                  if k.startswith("model.layers") or k == "lm_head.weight"
                                  or k in ("model.embed_tokens.weight", "model.norm.weight")},
                                 "cpu")
    bare = prefixed.rename(lambda k: k[len("model."):] if k.startswith("model.") else k)
    assert_trees_equal(hf_import.convert_qwen2(bare, cfg.lm),
                       hf_import.convert_qwen2(prefixed, cfg.lm))
    tower = hf_import.Tensors({k.replace("model.vision_tower.vision_tower.", ""): torch.from_numpy(v)
                               for k, v in sd.items() if "vision_tower" in k}, "cpu")
    assert next(iter(tower.keys())).startswith("vision_model.")
    full = hf_import.Tensors({k: torch.from_numpy(v) for k, v in sd.items()
                              if "vision_tower" in k}, "cpu")
    assert_trees_equal(hf_import.convert_siglip(tower, cfg.vision),
                       hf_import.convert_siglip(full, cfg.vision))


def test_unported_projector_raises(hf_state):
    with pytest.raises(NotImplementedError, match="item 8"):
        hf_import.convert_projector(hf_import.Tensors({}), "linear")


# ------------------------------------------------------------ HF export

def _read(path):
    with safetensors_io.CheckpointReader(path) as r:
        return {k: r.get(k).clone() for k in r.keys()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_loads_in_jax(ckpt_dir, tmp_path, dtype):  # noqa: F811
    _, model, _, _ = tload(ckpt_dir, torch_dtype=dtype, device_map="cpu")
    out = tmp_path / "port_export"
    path = checkpoint_io.export_hf_safetensors(model.params, model.cfg, str(out))
    assert path == str(out / "model.safetensors")
    with safe_open(path, framework="np") as f:  # fp32, as JAX's exporter writes
        assert {f.get_tensor(k).dtype for k in f.keys()} == {np.dtype(np.float32)}
    _, jmodel, _, _ = jload(str(out), None, "llava_qwen", torch_dtype=dtype)
    want = dict(model.params)
    want.pop("positional_encoding")
    got = _port_of_jax(jmodel.params, model.cfg)
    got.pop("positional_encoding")
    assert_trees_equal(got, want)


def test_jax_export_loads_in_the_port(ckpt_dir, tmp_path):  # noqa: F811
    _, jmodel, _, _ = jload(ckpt_dir, None, "llava_qwen", torch_dtype="float32")
    out = tmp_path / "jax_export"
    jorbax.export_hf_safetensors(jax.tree.map(np.asarray, jmodel.params), jmodel.cfg, str(out))
    _, model, _, _ = tload(str(out), torch_dtype="float32", device_map="cpu")
    assert_trees_equal(model.params, _port_of_jax(jmodel.params, model.cfg))
    # and the port's export of those params is JAX's, file for file
    mine = tmp_path / "port_again"
    checkpoint_io.export_hf_safetensors(model.params, model.cfg, str(mine))
    assert json.load(open(mine / "config.json")) == json.load(open(out / "config.json"))
    a, b = _read(str(mine)), _read(str(out))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_int8_export_is_dequantized(ckpt_dir, tmp_path):  # noqa: F811
    _, model, _, _ = tload(ckpt_dir, torch_dtype="float32", device_map="cpu", load_8bit=True)
    _, jmodel, _, _ = jload(ckpt_dir, None, "llava_qwen", torch_dtype="float32", load_8bit=True)
    checkpoint_io.export_hf_safetensors(model.params, model.cfg, str(tmp_path / "port"))
    jorbax.export_hf_safetensors(jax.tree.map(np.asarray, jmodel.params), jmodel.cfg,
                                 str(tmp_path / "jax"))
    a, b = _read(str(tmp_path / "port")), _read(str(tmp_path / "jax"))
    assert a.keys() == b.keys()
    w = "model.layers.0.mlp.down_proj.weight"
    lp = model.params["language_model"]["layers"][0]["down_proj"]
    torch.testing.assert_close(a[w], (lp["kernel_int8"].float() * lp["scale"]).t(),
                               rtol=0, atol=0)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=MEAN_ATOL, msg=k)


def test_untied_int8_unembedding_exports_as_lm_head(ckpt_dir, tmp_path):  # noqa: F811
    _, model, _, _ = tload(ckpt_dir, torch_dtype="float32", device_map="cpu")
    params = dict(model.params, language_model=tqwen2.prequantize_int8(
        model.params["language_model"], include_unembed=True))
    assert "lm_head" not in params["language_model"]
    checkpoint_io.export_hf_safetensors(params, model.cfg, str(tmp_path))
    lm = params["language_model"]
    got = _read(str(tmp_path))["lm_head.weight"]
    assert torch.equal(got, lm["unembed_int8"].float() * lm["unembed_scale"][:, None])


# ------------------------------------------------------- train state

PCFG = convert.config_from_fields(TINY)


def _state(seed=0):
    """A tiny train state with moments that are not zero, bf16 leaves and
    a column-major int8 kernel."""
    params = tvlm.init_params(PCFG, seed, "cpu")
    params["language_model"]["norm"] = params["language_model"]["norm"].bfloat16()
    params["vision_tower"] = tsiglip.prequantize_int8(params["vision_tower"])
    state = ttrainer.init_train_state(params, toptimizer.OptimizerConfig())
    g = torch.Generator().manual_seed(seed + 1)

    def fill(x):
        return None if x is None else torch.randn(x.shape, generator=g).to(x.dtype)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return fill(t)
    opt = state.opt_state._replace(count={k: 3 for k in state.opt_state.count},
                                   mu=walk(state.opt_state.mu), nu=walk(state.opt_state.nu))
    return state._replace(opt_state=opt, step=3)


def _assert_states_equal(got, want):
    assert type(got) is type(want) and got.step == want.step
    assert got.opt_state.count == want.opt_state.count
    for a, b in ((got.params, want.params), (got.opt_state.mu, want.opt_state.mu),
                 (got.opt_state.nu, want.opt_state.nu)):
        la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, x), (_, y) in zip(la, lb):
            if y is None:
                assert x is None, path_str(p)
                continue
            assert x.dtype == y.dtype and x.stride() == y.stride(), path_str(p)
            assert torch.equal(x, y), path_str(p)


@pytest.mark.parametrize("block", [True, False])
def test_train_state_round_trip_is_bit_equal(tmp_path, block):
    state = _state()
    path = checkpoint_io.save_checkpoint(str(tmp_path), state, 3, block=block)
    if not block:
        # the writer holds a copy: changing the state now changes nothing saved
        state_norm = state.params["language_model"]["norm"].clone()
        state.params["language_model"]["norm"].add_(1.0)
        checkpoint_io.wait_for_checkpoints()
        state.params["language_model"]["norm"].copy_(state_norm)
    assert path == os.path.join(str(tmp_path), "checkpoint-3")
    assert checkpoint_io.latest_checkpoint(str(tmp_path)) == path
    target = _state(seed=7)
    restored = checkpoint_io.restore_checkpoint(path, target)
    _assert_states_equal(restored, state)
    kern = restored.params["vision_tower"]["layers"][0]["fc1"]["kernel_int8"]
    assert kern.t().is_contiguous()  # the target's column-major layout


def test_keep_rule_and_latest_checkpoint(tmp_path):
    state = _state()
    for step in (1, 2, 3):
        checkpoint_io.save_checkpoint(str(tmp_path), state, step, keep=2, block=step != 2)
    checkpoint_io.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-3"]
    assert checkpoint_io.latest_checkpoint(str(tmp_path)).endswith("checkpoint-3")
    assert checkpoint_io.latest_checkpoint(str(tmp_path / "absent")) is None
    (tmp_path / "checkpoint-10.tmp").mkdir()  # a partial save is never the latest
    assert checkpoint_io.latest_checkpoint(str(tmp_path)).endswith("checkpoint-3")
    # JAX's keep rule on the same names
    jdir = tmp_path / "jax"
    for step in (1, 2, 3, 4):
        (jdir / f"checkpoint-{step}").mkdir(parents=True)
    jorbax._gc_checkpoints(str(jdir), 2)
    pdir = tmp_path / "port"
    for step in (1, 2, 3, 4):
        (pdir / f"checkpoint-{step}").mkdir(parents=True)
    checkpoint_io._gc_checkpoints(str(pdir), 2)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["checkpoint-3",
                                                                     "checkpoint-4"]


def test_background_save_raises_its_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    checkpoint_io.save_checkpoint(str(blocker), {"x": torch.zeros(2)}, 1, block=False)
    with pytest.raises(OSError):
        checkpoint_io.wait_for_checkpoints()
    checkpoint_io.wait_for_checkpoints()  # raised once


def test_restore_refuses_another_structure(tmp_path):
    path = checkpoint_io.save_checkpoint(str(tmp_path), {"a": torch.zeros(3), "n": 2}, 0)
    with pytest.raises(ValueError, match="keys"):
        checkpoint_io.restore_checkpoint(path, {"b": torch.zeros(3), "n": 0})
    with pytest.raises(ValueError, match="shape"):
        checkpoint_io.restore_checkpoint(path, {"a": torch.zeros(4), "n": 0})
    got = checkpoint_io.restore_checkpoint(path, {"a": torch.ones(3, dtype=torch.float64),
                                                  "n": 0})
    assert got["n"] == 2 and got["a"].dtype == torch.float64 and not got["a"].any()


# ------------------------------------------------------ delta, tokenizer

def _np(tree):
    """The port's tree with numpy leaves, the structure kept (JAX's delta
    functions take any pytree)."""
    return jax.tree.map(lambda t: t.numpy(), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_delta_matches_jax():
    base = tvlm.init_params(PCFG, 0, "cpu")
    target = tvlm.init_params(PCFG, 1, "cpu")
    # a resized table, and a module the base lacks
    target["language_model"]["embed_tokens"] = torch.cat(
        [target["language_model"]["embed_tokens"], torch.randn(3, 32)])
    del base["mm_projector"]
    d = tdelta.make_delta(base, target)
    assert_trees_equal(d, _torch(jdelta.make_delta(_np(base), _np(target))))
    assert torch.equal(d["mm_projector"]["layers"][0]["kernel"],
                       target["mm_projector"]["layers"][0]["kernel"])
    back = tdelta.apply_delta(base, d)
    assert_trees_equal(back, _torch(jdelta.apply_delta(_np(base), _np(d))))
    # (t - b) + b is t to within a rounding of the larger of the two
    for (p, x), (_, y) in zip(leaves_with_path(back), leaves_with_path(target)):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-6, msg=path_str(p))
    half = tdelta.consolidate(target)
    assert_trees_equal(half, _torch(jdelta.consolidate(_np(target))))
    assert all(x.dtype == torch.float16 for _, x in leaves_with_path(half))


@pytest.mark.parametrize("new_vocab,tied", [(50010, False), (50010, True), (49990, False)])
def test_resize_token_embeddings_matches_jax(new_vocab, tied):
    lm = tvlm.init_params(PCFG, 0, "cpu")["language_model"]
    lm["lm_head"] = torch.randn(32, lm["embed_tokens"].shape[0])
    got = ttok_init.resize_token_embeddings(lm, new_vocab, tied)
    want = jtok_init.resize_token_embeddings(
        {"embed_tokens": lm["embed_tokens"].numpy(), "lm_head": lm["lm_head"].numpy()},
        new_vocab, tied)
    old = lm["embed_tokens"].shape[0]
    keep = min(old, new_vocab)
    emb, jemb = got["embed_tokens"], np.asarray(want["embed_tokens"])
    assert emb.shape == jemb.shape == (new_vocab, 32)
    np.testing.assert_array_equal(emb[:keep].numpy(), jemb[:keep])
    np.testing.assert_allclose(emb[keep:].numpy(), jemb[keep:], rtol=0, atol=MEAN_ATOL)
    head, jhead = got["lm_head"], np.asarray(want["lm_head"])
    assert head.shape == jhead.shape
    np.testing.assert_array_equal(head[:, :keep].numpy(), jhead[:, :keep])
    np.testing.assert_allclose(head[:, keep:].numpy(), jhead[:, keep:], rtol=0, atol=MEAN_ATOL)


def test_initialize_vision_tokenizer_matches_jax(ckpt_dir):  # noqa: F811
    from transformers import AutoTokenizer

    tok, jt = AutoTokenizer.from_pretrained(ckpt_dir), AutoTokenizer.from_pretrained(ckpt_dir)
    vocab = len(tok)
    table = 0.02 * torch.randn(vocab, 32, generator=torch.Generator().manual_seed(0))
    got, tok = ttok_init.initialize_vision_tokenizer(
        {"language_model": {"embed_tokens": table}}, tok, tie_word_embeddings=True,
        mm_use_im_patch_token=True, mm_use_im_start_end=True)
    want, jt = jtok_init.initialize_vision_tokenizer(
        {"language_model": {"embed_tokens": table.numpy()}}, jt, tie_word_embeddings=True,
        mm_use_im_patch_token=True, mm_use_im_start_end=True)
    assert len(tok) == len(jt) == vocab + 3
    emb = got["language_model"]["embed_tokens"]
    jemb = np.asarray(want["language_model"]["embed_tokens"])
    np.testing.assert_array_equal(emb[:vocab].numpy(), jemb[:vocab])
    np.testing.assert_allclose(emb[vocab:].numpy(), jemb[vocab:], rtol=0, atol=MEAN_ATOL)
    assert tok.convert_tokens_to_ids("<im_end>") == jt.convert_tokens_to_ids("<im_end>")
    same, _ = ttok_init.initialize_vision_tokenizer({"language_model": {}}, tok,
                                                    tie_word_embeddings=True)
    assert same == {"language_model": {}}  # nothing added, nothing resized
