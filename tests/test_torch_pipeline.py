"""The port's clip -> answer path against `bench.build_pipeline` on the tiny
config of tests/test_vlm.py, and the import hygiene of the port and of
chip_smoke.py.

12 frames run one partially valid segment; 96 frames run 12 segments, more
than the ring cache's 10, so the cache rolls. Same converted weights and
numpy pixels on both sides, fp32: spliced length and greedy tokens equal,
prefill logits within rtol/atol 1e-4.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_torch import convert, pipeline
from test_vlm import TINY

MAX_NEW = 6
# the bench's prompt ids exceed the tiny vocab (50000): other ids, same lengths
TEXT_BEFORE = np.array([11, 872, 198], np.int32)
TEXT_AFTER = np.array([3838, 374, 12482, 304, 419, 2766, 30, 4545, 198, 1644, 7791, 198],
                      np.int32)


@pytest.fixture(scope="module")
def weights():
    params = jvlm.init_params(TINY, jax.random.key(0))
    port = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                   convert.config_from_fields(TINY), device="cpu")
    return params, port


@pytest.mark.parametrize("num_frames", [12, 96])
def test_pipeline_matches_bench(weights, num_frames):
    jparams, tparams = weights
    pix = np.random.default_rng(num_frames).standard_normal(
        (num_frames, 56, 56, 3)).astype(np.float32)
    jfn, jnseg = bench.build_pipeline(TINY, num_frames, return_prefill_logits=True,
                                      max_new_tokens=MAX_NEW)
    jtok, js, jlogits = jax.jit(jfn)(jparams, jnp.asarray(pix), jnp.asarray(TEXT_BEFORE),
                                     jnp.asarray(TEXT_AFTER))
    tfn, tnseg = pipeline.build_pipeline(convert.config_from_fields(TINY), num_frames,
                                         return_logits=True, max_new_tokens=MAX_NEW)
    ttok, ts, tlogits = tfn(tparams, torch.from_numpy(pix), torch.from_numpy(TEXT_BEFORE),
                            torch.from_numpy(TEXT_AFTER))
    assert tnseg == jnseg == min(-(-num_frames // 8), 10)
    assert ts == int(js) == (len(TEXT_BEFORE) + len(TEXT_AFTER) + 10 + tnseg * 2 * 4 + 1
                             + 9 + min(4, num_frames) * 4 + 1)
    assert tlogits.shape == (MAX_NEW, 1, TINY.lm.vocab_size)
    np.testing.assert_allclose(tlogits[0].numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# after the imports: no JAX, and nothing of the JAX package, not even a
# module of it that does not import JAX
_NO_JAX = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
           "             ('jax', 'memory_augmented_vlm_tpu'))\n"
           "assert not bad, bad\n")


def test_port_imports_no_jax():
    pkg = Path(__file__).resolve().parent.parent / "memory_augmented_vlm_torch"
    modules = sorted(
        "memory_augmented_vlm_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    assert "memory_augmented_vlm_torch.pipeline" in modules
    assert "memory_augmented_vlm_torch.constants" in modules
    for m in ("ops.flash_bwd", "train.optimizer", "train.trainer", "utils.tree",
              "ops.pallas_int8", "ops.swiglu_int8", "ops.mlp_int8", "ops.int8_common",
              "bench", "bench_train", "models.sampling", "models.beam_search",
              *LOADING_MODULES, *EVAL_MODULES, *TRAIN_MODULES, *SERVING_MODULES,
              *RL_MODULES):
        assert "memory_augmented_vlm_torch." + m in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n" + _NO_JAX)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=pkg.parent, timeout=120)


# the modules of checkpoint loading, which the card's machine may run
# without the packages below: they import them only where they are used
LOADING_MODULES = ("models.registry", "checkpoint.safetensors_io", "checkpoint.hf_import",
                   "checkpoint.checkpoint_io", "checkpoint.delta", "models.tokenizer_init",
                   "config", "data.preprocessing", "data.tokenizer", "data.conversation",
                   "data.video", "data.native_loader", "eval.model", "eval.builder")
OPTIONAL_PACKAGES = ("safetensors", "transformers", "tokenizers", "PIL")
# the evaluation entries and the image path
EVAL_MODULES = ("ops.preprocess", "models.image_path", "eval.model_vqa", "eval.lmms_adapter",
                "eval.eval_bridge", "eval.gpt_eval", "eval.evaluate_interleave", "predict")
# the training entry, its data layer and the SFT, LoRA and DPO trainers
TRAIN_MODULES = ("train.cli", "train.sft", "train.lora", "train.dpo", "train.dataset_formatting",
                 "data.sampler", "data.collator", "data.dataset", "data.dpo_dataset",
                 "utils.logging")
# the continuous-batching engine, the paged cache, the serving benchmarks and
# the HTTP stack
SERVING_MODULES = ("serve.batch_engine", "models.paged", "bench_serving", "bench_throughput",
                   "serve.client", "serve.controller", "serve.model_worker",
                   "serve.sglang_worker", "serve.web_server", "serve.cli")
# the TRL extras: PPO with a value head, the reward model, iterative SFT,
# best-of-N, the tool-use text environment, DDPO
RL_MODULES = ("train.ppo", "train.reward", "train.iterative_sft", "train.best_of_n",
              "train.text_environment", "train.ddpo")


@pytest.mark.parametrize("module", LOADING_MODULES)
def test_loading_modules_import_no_optional_package(module):
    root = Path(__file__).resolve().parent.parent
    code = ("import importlib, sys\n"
            f"importlib.import_module('memory_augmented_vlm_torch.{module}')\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {OPTIONAL_PACKAGES!r})\n"
            "assert not bad, bad\n" + _NO_JAX)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


def test_chip_smoke_imports_no_jax():
    """Importing chip_smoke runs nothing (its main() sits behind __main__)
    and pulls in no JAX, though it imports every kernel module."""
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\nimport chip_smoke\n"
            "for m in ('pallas_int8', 'swiglu_int8', 'mlp_int8', 'flash'):\n"
            "    assert 'memory_augmented_vlm_torch.ops.' + m in sys.modules, m\n" + _NO_JAX)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
