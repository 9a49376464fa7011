"""The port's train-step benchmark entry (`memory_augmented_vlm_torch.bench_train`)
against the root `bench_train.py` and the JAX package on the CPU.

- `baseline_train_step_s` equal to bench_train.py's, to the bit;
- `make_batch`: every field equal to bench_train.make_batch's for one
  numpy seed (a 20-frame clip: the padding to a whole segment runs);
- the metric name, the JSON keys (bench_train.py's less `impl`, `staged`,
  `vs_baseline_iso_peak` and `backend`, plus the peak memory and the
  card), and `main` raising without a card;
- a train step of the tiny config of tests/test_vlm.py on make_batch's
  batch at 75 frames, which pad to 10 segments of 8: the ring cache's cap,
  bench_train's `--frames 300` case at the tiny scale. Loss and every
  gradient leaf against JAX's with test_torch_train.py's tolerances.
"""

import ast
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bench_train
from memory_augmented_vlm_tpu.config import VLMConfig as JVLMConfig
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_torch import bench_train as tbench_train
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.train import trainer as ttrainer
from test_torch_train import GRAD_TOL, LOSS_TOL, _assert_tree_close
from test_vlm import TINY

PCFG = convert.config_from_fields(TINY)


@pytest.mark.parametrize("frames", [16, 32, 64, 128, 300, 400])
def test_baseline_train_step_s_equals_bench_train(frames):
    assert tbench_train.baseline_train_step_s(frames) == bench_train.baseline_train_step_s(frames)


def test_make_batch_equals_bench_train():
    want = bench_train.make_batch(np.random.default_rng(5), JVLMConfig.onevision_0_5b(), 20)
    got = tbench_train.make_batch(np.random.default_rng(5), VLMConfig.onevision_0_5b(), 20,
                                  "cpu")
    assert got.pixels.shape == (1, 32, 384, 384, 3)
    for name in jtrainer.TrainBatch._fields:
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point()
                                      else a.numpy(), np.asarray(b, np.float32 if
                                                                 a.is_floating_point()
                                                                 else None), err_msg=name)
    assert int(got.frame_valid.sum()) == 20 and not got.pixels[0, 20:].any()


def _bench_train_keys():
    """The keys of the JSON line in bench_train.py's main (top level, detail)."""
    tree = ast.parse((Path(bench_train.__file__)).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps":
            line = node.args[0]
            detail = next(v for k, v in zip(line.keys, line.values) if k.value == "detail")
            return {k.value for k in line.keys}, {k.value for k in detail.keys}
    raise AssertionError("no json.dumps in bench_train.py")


def test_json_line_has_bench_train_keys_less_the_tpu_ones():
    top, detail = _bench_train_keys()
    out = tbench_train.result(300, 10, [2.5, 2.25], 30.0, 11.9, 11.8, 40.0,
                              "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(out) == top - {"impl"}
    assert set(out["detail"]) == (detail - {"staged", "vs_baseline_iso_peak", "backend"}
                                  | {"peak_memory_gb", "card"})
    assert out["metric"] == "train_step_s_0.5b_300frame"
    assert out["value"] == 2.25 and out["detail"]["all_times"] == [2.5, 2.25]
    assert out["vs_baseline"] == round(bench_train.baseline_train_step_s(300) / 2.25, 3)


def test_metric_name_matches_bench_train_template():
    src = Path(bench_train.__file__).read_text()
    assert '"metric": f"train_step_s_0.5b_{args.frames}frame"' in src
    assert tbench_train.metric_name(64) == "train_step_s_0.5b_64frame"


def test_main_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench_train.main(["--iters", "1"])


@pytest.mark.parametrize("flag", [["--frams", "300"], ["--impl", "pallas"], ["--staged"]])
def test_main_refuses_flags_it_does_not_take(flag):
    """A misspelt flag, or JAX's `--impl` and `--staged`, stops the run
    before it measures anything (bench_train.py parses strictly too)."""
    with pytest.raises(SystemExit):
        tbench_train.main(flag)


def test_train_step_at_the_ring_cache_cap_matches_jax():
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    tp = convert.from_jax_params(jp, PCFG, device="cpu")
    tb = tbench_train.make_batch(np.random.default_rng(3), PCFG, 75, "cpu")
    tb = tb._replace(pixels=tb.pixels.float())  # bf16 values, fp32 weights: widen both
    jb = jtrainer.TrainBatch(**{name: jnp.asarray(getattr(tb, name).numpy())
                                for name in jtrainer.TrainBatch._fields})
    fmax = tb.pixels.shape[1]
    nseg = min(fmax // TINY.memory.segment_frames, TINY.memory.cache_cap)
    assert fmax == 80 and nseg == TINY.memory.cache_cap == 10

    (jloss, jm), jgrads = jax.jit(lambda p: jtrainer.value_and_grad_params(
        lambda q: jtrainer.multimodal_loss(q, TINY, jb, nseg=nseg), p))(jp)
    (tloss, tm), tgrads = ttrainer.value_and_grad_params(
        lambda q: ttrainer.multimodal_loss(q, PCFG, tb, nseg=nseg), tp)
    assert int(tm["target_tokens"]) == int(jm["target_tokens"]) == tbench_train.ST - 8
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree_close(tgrads, jgrads, **GRAD_TOL)
