"""The port's data layer and training utilities against the JAX package's:
`data/collator.py`, `data/sampler.py`, `data/dataset.py` (manifests,
sampling strategies, every `PREPROCESS_FUNCS` template,
`LazySupervisedDataset`), `data/dpo_dataset.py`,
`train/dataset_formatting.py`, `utils/logging.py`, and
`trainer.synced_frame_dropout`. Same manifests and tokenizers on both
sides; the outputs are numpy and must be bit-equal.
"""

import json
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from memory_augmented_vlm_tpu.data import collator as jcollator
from memory_augmented_vlm_tpu.data import dataset as jdataset
from memory_augmented_vlm_tpu.data import dpo_dataset as jdpo_dataset
from memory_augmented_vlm_tpu.data import sampler as jsampler
from memory_augmented_vlm_tpu.train import dataset_formatting as jfmt
from memory_augmented_vlm_tpu.utils import logging as jlogging
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.data import collator as tcollator
from memory_augmented_vlm_torch.data import dataset as tdataset
from memory_augmented_vlm_torch.data import dpo_dataset as tdpo_dataset
from memory_augmented_vlm_torch.data import sampler as tsampler
from memory_augmented_vlm_torch.train import dataset_formatting as tfmt
from memory_augmented_vlm_torch.train import trainer as ttrainer
from memory_augmented_vlm_torch.utils import logging as tlogging
from tests.test_data_pipeline import FakeTokenizer
from tests.test_vlm import TINY

PCFG = convert.config_from_fields(TINY)


class SpecialTokenizer(FakeTokenizer):
    """FakeTokenizer with the other templates' special tokens and eos/bos."""

    SPECIALS = dict(FakeTokenizer.SPECIALS, **{
        "<|start_header_id|>": 4, "<|end_header_id|>": 5, "<|eot_id|>": 6,
        "<|begin_of_text|>": 7, "<start_of_turn>": 8, "<end_of_turn>": 9})
    eos_token_id = 2
    bos_token_id = 7


def _assert_same(got, want, where=""):
    """Equal dicts / lists of numpy arrays and plain values, dtypes too."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
        # np.array_equal: assert_array_equal is seconds slower on the pixels
        assert got.shape == want.shape and np.array_equal(got, want), where
    else:
        assert got == want, (where, got, want)


@pytest.fixture()
def manifest(tmp_path):
    """Six 10-frame videos, one of 70 frames (re-sampled by the collator),
    an image, two text-only samples, and one video without its sentinel."""
    from PIL import Image

    rng = np.random.default_rng(0)
    vids = tmp_path / "videos"
    vids.mkdir()
    items = []
    for i, n in enumerate([10, 10, 10, 10, 10, 10, 70]):
        np.save(vids / f"v{i}.npy", rng.integers(0, 255, size=(n, 56, 56, 3), dtype=np.uint8))
        items.append({"id": i, "video": f"v{i}.npy", "conversations": [
            {"from": "human", "value": f"<image> describe clip {i}"},
            {"from": "gpt", "value": "something happens " * (i + 1)}]})
    Image.fromarray(rng.integers(0, 255, size=(40, 64, 3), dtype=np.uint8)).save(
        tmp_path / "img.png")
    items.append({"id": 7, "image": str(tmp_path / "img.png"), "conversations": [
        {"from": "human", "value": "what is this"}, {"from": "gpt", "value": "a picture"}]})
    items += [{"id": 8, "conversations": [{"from": "human", "value": "just text"},
                                          {"from": "gpt", "value": "sure thing here"}]},
              {"id": 9, "conversations": [{"from": "human", "value": "more text please"},
                                          {"from": "gpt", "value": "yes indeed friend"}]},
              {"id": 10, "video": "v0.npy", "conversations": [
                  {"from": "human", "value": "no sentinel here"},
                  {"from": "gpt", "value": "fine"}]}]
    path = tmp_path / "data.json"
    path.write_text(json.dumps(items))
    return tmp_path, path


def _datasets(path, vids, **kw):
    """Each package's dataset over the manifest, each with its own
    tokenizer (a FakeTokenizer hands out ids in the order it meets words)."""
    return (jdataset.LazySupervisedDataset(str(path), SpecialTokenizer(), video_folder=str(vids),
                                           **kw),
            tdataset.LazySupervisedDataset(str(path), SpecialTokenizer(), video_folder=str(vids),
                                           **kw))


# ------------------------------------------------------- frame dropout

@pytest.mark.parametrize("seed", [17, 1234])
def test_synced_frame_dropout_matches_jax(seed):
    """JAX's uniform(fold_in(key(seed), step)) for steps 0..4095, bit for
    bit, and the decisions at 0.5 and 0.3."""
    steps = np.arange(4096)
    want = np.asarray(jax.vmap(lambda s: jax.random.uniform(
        jax.random.fold_in(jax.random.key(seed), s)))(jnp.asarray(steps)))
    got = np.array([ttrainer.step_uniform(int(s), seed) for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for prob in (0.5, 0.3):
        decisions = [ttrainer.synced_frame_dropout(int(s), prob, seed) for s in steps[:512]]
        assert decisions == [bool(u < prob) for u in want[:512]]
    if seed == 17:  # the CLI's default draw, as JAX's own function gives it
        from memory_augmented_vlm_tpu.train import trainer as jtrainer

        assert [ttrainer.synced_frame_dropout(s) for s in range(64)] == \
            [jtrainer.synced_frame_dropout(s) for s in range(64)]


# ------------------------------------------------------------- dataset

@pytest.mark.parametrize("time_instruction", [False, True])
def test_lazy_supervised_dataset_matches_jax(manifest, time_instruction):
    tmp, path = manifest
    jpipe = TINY.pipeline.__class__(add_time_instruction=time_instruction)
    jds, tds = _datasets(path, tmp / "videos", pipeline=jpipe)
    tds.pipeline = convert.config_from_fields(
        TINY.__class__(pipeline=jpipe)).pipeline
    assert len(tds) == len(jds) == 11
    assert tds.modality_lengths == jds.modality_lengths
    for i in range(len(jds)):
        _assert_same(tds[i], jds[i], f"item {i}")


@pytest.mark.parametrize("version", sorted(jdataset.PREPROCESS_FUNCS))
def test_preprocess_funcs_match_jax(version):
    convs = [{"from": "human", "value": "<image>\nwhat happens next here"},
             {"from": "gpt", "value": "the cat jumps"},
             {"from": "human", "value": "and then"},
             {"from": "gpt", "value": "it sleeps"}]
    if version in ("plain", "llava_plain"):
        convs = convs[:2]
    assert set(tdataset.PREPROCESS_FUNCS) == set(jdataset.PREPROCESS_FUNCS)
    _assert_same(tdataset.PREPROCESS_FUNCS[version](convs, SpecialTokenizer()),
                 jdataset.PREPROCESS_FUNCS[version](convs, SpecialTokenizer()))


def test_manifest_formats_and_sampling_strategies_match_jax(tmp_path):
    import yaml
    a = [{"id": i, "conversations": []} for i in range(20)]
    b = [{"id": 100 + i, "conversations": []} for i in range(10)]
    (tmp_path / "a.json").write_text(json.dumps(a))
    (tmp_path / "b.jsonl").write_text("\n".join(json.dumps(x) for x in b))
    spec = {"datasets": [{"json_path": str(tmp_path / "a.json"), "sampling_strategy": "random:7"},
                         {"json_path": str(tmp_path / "b.jsonl"), "sampling_strategy": "end:30%"},
                         {"json_path": str(tmp_path / "a.json"), "sampling_strategy": "first:3"}]}
    (tmp_path / "mix.yaml").write_text(yaml.safe_dump(spec))
    random.seed(5)
    want = jdataset.load_data_manifest(str(tmp_path / "mix.yaml"))
    random.seed(5)
    got = tdataset.load_data_manifest(str(tmp_path / "mix.yaml"))
    assert got == want and len(got) == 7 + 3 + 3
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        tdataset._apply_sampling_strategy(a, "middle:3")


def test_dataset_retry_ladder_matches_jax(tmp_path):
    items = [{"id": 0, "video": "missing.npy", "conversations": [
                 {"from": "human", "value": "<image> x"}, {"from": "gpt", "value": "y"}]},
             {"id": 1, "conversations": [{"from": "human", "value": "a"},
                                         {"from": "gpt", "value": "b"}]}]
    path = tmp_path / "d.json"
    path.write_text(json.dumps(items))
    jds, tds = _datasets(path, tmp_path)
    _assert_same(tds[0], jds[0])  # falls through to the next index
    assert tds[0]["id"] == 1
    with pytest.raises(ValueError, match="Unknown conversation version"):
        tdataset.LazySupervisedDataset(str(path), SpecialTokenizer(), conv_version="nope")


def test_dpo_dataset_matches_jax(manifest):
    tmp, _ = manifest
    items = [{"id": 0, "video": "v1.npy", "prompt": "which is right", "chosen": "the left one",
              "rejected": "the right one"},
             {"id": 1, "prompt": "say hi", "chosen": "hi there", "rejected": "go away"},
             {"id": 2, "chosen": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "a"}],
              "rejected": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "b"}]}]
    path = tmp / "dpo.json"
    path.write_text(json.dumps(items))
    pipe = TINY.pipeline.__class__(add_time_instruction=True)
    jds = jdpo_dataset.DPODataset(str(path), SpecialTokenizer(), video_folder=str(tmp / "videos"),
                                  pipeline=pipe)
    tds = tdpo_dataset.DPODataset(str(path), SpecialTokenizer(), video_folder=str(tmp / "videos"),
                                  pipeline=convert.config_from_fields(
                                      TINY.__class__(pipeline=pipe)).pipeline)
    for i in range(3):
        _assert_same(tds[i], jds[i], f"pair {i}")
    assert "chosen_input_ids" in tds[0] and "pixels" in tds[0]


# ------------------------------------------------------------ collator

def test_collator_and_bucket_keys_match_jax(manifest):
    tmp, path = manifest
    jds, tds = _datasets(path, tmp / "videos")
    samples = [tds[i] for i in range(len(tds))]
    for s in samples:
        if s["modality"] == "image":
            continue
        assert tcollator.bucket_key(s, PCFG.memory) == jcollator.bucket_key(s, TINY.memory)
    videos = [s for s in samples if s["modality"] == "video"]
    for group in (videos[:2], videos[5:7], videos):
        _assert_same(tcollator.collate_video_batch(group, PCFG.memory, pad_token_id=3),
                     jcollator.collate_video_batch(group, TINY.memory, pad_token_id=3))
    texts = [s for s in samples if s["modality"] == "text"]
    _assert_same(tcollator.collate_text_batch(texts, text_buckets=(4, 8)),
                 jcollator.collate_text_batch(texts, text_buckets=(4, 8)))
    # the long video re-samples to 64 frames, two segments
    assert tcollator.collate_video_batch([videos[6]], PCFG.memory)["pixels"].shape[1] == 64


# ------------------------------------------------------------- sampler

@pytest.mark.parametrize("group_by_modality", [False, True])
def test_length_grouped_sampler_matches_jax(group_by_modality):
    rng = np.random.default_rng(3)
    lengths = [int(x) * (1 if rng.random() < 0.6 else -1) for x in rng.integers(1, 500, 97)]
    for epoch in (0, 1):
        samplers = []
        for mod in (jsampler, tsampler):
            s = mod.LengthGroupedSampler(4, 2, lengths, group_by_modality=group_by_modality,
                                         seed=11)
            s.set_epoch(epoch)
            samplers.append(list(s))
        assert samplers[0] == samplers[1] and sorted(samplers[1]) == list(range(97))
    assert tsampler.split_to_even_chunks(list(range(8)), list(range(8)), 2) == \
        jsampler.split_to_even_chunks(list(range(8)), list(range(8)), 2)
    with pytest.raises(ValueError, match="non-zero"):
        tsampler.get_modality_length_grouped_indices([3, 0, -2], 1, 1)


# ---------------------------------------------------- dataset formatting

@pytest.mark.parametrize("schema", ["messages", "conversations", "prompt", "unknown"])
def test_dataset_formatting_matches_jax(schema):
    chat = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"}]
    data = {"messages": [{"messages": chat}], "conversations": [{"conversations": chat}],
            "prompt": [{"prompt": "2+2?", "completion": "4"}],
            "unknown": [{"text": "raw"}]}[schema]
    jf, tf = jfmt.get_formatting_func_from_dataset(data), tfmt.get_formatting_func_from_dataset(data)
    if schema == "unknown":
        assert jf is None and tf is None
        return
    assert tf(data[0]) == jf(data[0])
    batch = {k: [v, v] for k, v in data[0].items()}
    assert tf(batch) == jf(batch)
    with pytest.raises(ValueError, match="unknown chat role"):
        tfmt._render_chat([{"role": "robot", "content": "x"}], "qwen_1_5")


# -------------------------------------------------------------- logging

def test_metrics_logger_and_step_timer_match_jax(tmp_path):
    recs = [(1, {"loss": np.float32(2.5), "grad_norm": 0.25, "tag": "x"}), (2, {"loss": 1.0})]
    for mod, sub in ((jlogging, "jax"), (tlogging, "torch")):
        log = mod.MetricsLogger(str(tmp_path / sub))
        for step, m in recs:
            log.log(step, m)
    assert (tmp_path / "torch" / "metrics.jsonl").read_text() == \
        (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert tlogging.is_main_process()
    timer = tlogging.StepTimer(ema=0.5)
    for _ in range(2):
        with timer.section("data"):
            pass
    assert set(timer.summary()) == set(timer.last) == {"data"}


def test_profiled_sections_are_named_spans(tmp_path):
    """The StepTimer's sections are torch.profiler spans in the Chrome trace
    that stop_profiler writes."""
    import torch

    timer = tlogging.StepTimer()
    tlogging.start_profiler(str(tmp_path))
    for name in ("data", "step", "checkpoint"):
        with timer.section(name):
            torch.ones(4).sum()
    path = tlogging.stop_profiler()
    names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"data", "step", "checkpoint"} <= names
    with pytest.raises(RuntimeError):
        tlogging.stop_profiler()
