"""The port's train CLI (`memory_augmented_vlm_torch/train/cli.py`) against
JAX's (`memory_augmented_vlm_tpu/train/cli.py`) on the tiny config of
tests/test_vlm.py, fp32, on the CPU.

Both CLIs get the same weights (JAX's init carried across with
`convert.from_jax_params`) and the same manifest, through `build_model`
replaced as tests/test_train_cli.py replaces it. Each run writes under
`tmp_path`. The losses and grad norms of `metrics.jsonl` are held at every
micro-step to LOSS_TOL and rtol 1e-5 (tests/test_torch_train.py), the
parameters of the checkpoints and of the HF exports to PARAM_ATOL; the
accumulation state (micro-step, accumulated step, the running mean) of a
checkpoint taken in the middle of an accumulation to GRAD_TOL.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu.checkpoint import orbax_io
from memory_augmented_vlm_tpu.models import siglip as jsiglip
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_tpu.train import cli as jcli
from memory_augmented_vlm_tpu.train import optimizer as jopt
from memory_augmented_vlm_tpu.train import trainer as jtrainer
from memory_augmented_vlm_torch import convert
from memory_augmented_vlm_torch.checkpoint import checkpoint_io, safetensors_io
from memory_augmented_vlm_torch.train import cli as tcli
from memory_augmented_vlm_torch.train import trainer as ttrainer
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str
from tests.test_data_pipeline import FakeTokenizer
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_ATOL, _assert_tree_close
from tests.test_vlm import TINY

PCFG = convert.config_from_fields(TINY)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jvlm.init_params(TINY, key))(jax.random.key(0)))  # one compile


def _write_manifest(root, items, videos):
    vids = root / "videos"
    vids.mkdir(exist_ok=True)
    for name, frames in videos.items():
        np.save(vids / name, frames)
    (root / "data.json").write_text(json.dumps(items))
    return str(root / "data.json"), str(vids)


def _video_item(i, name, answer):
    return {"id": i, "video": name, "conversations": [
        {"from": "human", "value": "<image> describe"}, {"from": "gpt", "value": answer}]}


@pytest.fixture()
def mixed(tmp_path):
    """tests/test_train_cli.py's six 10-frame videos and two text samples."""
    rng = np.random.default_rng(0)
    videos = {f"v{i}.npy": rng.integers(0, 255, size=(10, 56, 56, 3), dtype=np.uint8)
              for i in range(6)}
    items = [_video_item(i, f"v{i}.npy", "something happens") for i in range(6)]
    items += [{"id": 100, "conversations": [{"from": "human", "value": "just text"},
                                            {"from": "gpt", "value": "sure thing here"}]},
              {"id": 101, "conversations": [{"from": "human", "value": "more text"},
                                            {"from": "gpt", "value": "yes indeed friend"}]}]
    return _write_manifest(tmp_path, items, videos)


def _argv(data, vids, out, *extra):
    return ["--data_path", data, "--video_folder", vids, "--output_dir", out,
            "--per_device_train_batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_ratio", "0.0", "--mesh_fsdp", "1", "--seed", "7", *extra]


def _run_port(monkeypatch, jp, argv, cfg=PCFG):
    monkeypatch.setattr(tcli, "build_model", lambda args: (
        FakeTokenizer(), convert.from_jax_params(jp, cfg, device="cpu"), cfg))
    return tcli.main(argv)


def _run_jax(monkeypatch, jp, argv, cfg=TINY):
    monkeypatch.setattr(jcli, "build_model", lambda args: (
        FakeTokenizer(), jax.tree.map(jnp.asarray, jp), cfg))
    args = jcli.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return jcli.train(args)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_records_match(port_out, jax_out):
    """One record per micro-step in both files (JAX's `step` key holds its
    step section's time, the port's the count)."""
    got, want = _records(port_out), _records(jax_out)
    assert [r["step"] for r in got] == list(range(1, len(want) + 1))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], **LOSS_TOL, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5,
                                   err_msg=f"step {i + 1}")
        assert g["target_tokens"] == w["target_tokens"]
    return got


def _assert_exports_match(port_out, jax_out, atol=PARAM_ATOL):
    paths = [os.path.join(o, "hf_export", "model.safetensors") for o in (port_out, jax_out)]
    with safetensors_io.SafetensorsFile(paths[0]) as t, \
            safetensors_io.SafetensorsFile(paths[1]) as j:
        assert set(t.keys()) == set(j.keys())
        for k in j.keys():
            np.testing.assert_allclose(t.get(k).numpy(), j.get(k).numpy(), rtol=0, atol=atol,
                                       err_msg=k)
    for o in (port_out, jax_out):
        assert json.load(open(os.path.join(o, "hf_export", "config.json")))


def _opt_cfgs(total_steps, k):
    jcfg = jopt.OptimizerConfig(learning_rate=1e-3, grad_accum_steps=k, warmup_ratio=0.0,
                                total_steps=total_steps)
    return jcfg, ttrainer.OptimizerConfig(**dataclasses.asdict(jcfg))


def test_cli_matches_jax_cli_with_accumulation_and_frame_dropout(mixed, tmp_path, monkeypatch,
                                                                jax_params):
    """k = 2, B = 2, --dropout_frames over the mixed manifest, 3 accumulated
    steps (6 micro-steps): the same per-micro-step metrics, a checkpoint
    in the middle of an accumulation (micro-step 3) with the same state,
    and the same exports; the dropout decisions are synced_frame_dropout's."""
    data, vids = mixed
    extra = ("--gradient_accumulation_steps", "2", "--max_steps", "3", "--save_steps", "3",
             "--dropout_frames")
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    tlast = _run_port(monkeypatch, jax_params, _argv(data, vids, tout, *extra))
    jlast = _run_jax(monkeypatch, jax_params, _argv(data, vids, jout, *extra))
    orbax_io.wait_for_checkpoints()
    np.testing.assert_allclose(tlast["loss"], jlast["loss"], **LOSS_TOL)
    recs = _assert_records_match(tout, jout)
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    videos = [r for r in recs if "dropped_frames" in r]  # text batches drop nothing
    for r in videos:  # decided at the count before the micro-step
        assert r["dropped_frames"] == ttrainer.synced_frame_dropout(r["step"] - 1)
    assert any(r["dropped_frames"] for r in videos) and len(videos) < len(recs)
    _assert_exports_match(tout, jout)

    # the mid-accumulation checkpoint: params, mean and counters as JAX's
    # (train.log is written by the first CLI of a process only, in either package)
    assert sorted(n for n in os.listdir(tout) if n.startswith("checkpoint-")) == \
        sorted(n for n in os.listdir(jout) if n.startswith("checkpoint-")) == \
        ["checkpoint-3", "checkpoint-6"]
    jcfg, tcfg = _opt_cfgs(3, 2)
    tparams = convert.from_jax_params(jax_params, PCFG, device="cpu")
    tstate = checkpoint_io.restore_checkpoint(os.path.join(tout, "checkpoint-3"),
                                              ttrainer.init_train_state(tparams, tcfg))
    jstate = orbax_io.restore_checkpoint(
        os.path.join(jout, "checkpoint-3"),
        jtrainer.init_train_state(jax.tree.map(jnp.asarray, jax_params), jcfg))
    assert tstate.step == int(jstate.step) == 3
    assert tstate.opt_state.mini_step == int(jstate.opt_state.mini_step) == 1
    assert tstate.opt_state.gradient_step == int(jstate.opt_state.gradient_step) == 1
    _assert_tree_close(tstate.params, jstate.params, rtol=0, atol=PARAM_ATOL)
    acc = {k: v for k, v in tstate.opt_state.acc_grads.items() if k != "vision_tower"
           and k != "mm_projector" and k != "positional_encoding"}
    jacc = {k: jstate.opt_state.acc_grads[k] for k in acc}
    _assert_tree_close(acc, jacc, **GRAD_TOL)


def test_auto_resume_mid_accumulation_equals_the_uninterrupted_run(tmp_path, monkeypatch,
                                                                   jax_params):
    """A run stopped right after the checkpoint of micro-step 3 (k = 2) and
    run again resumes there (mean, counters, schedule) and ends where the
    uninterrupted run ends, bit for bit. The CLI, as JAX's, starts its data
    order over after a resume, so every sample here is the same video and
    text and only the checkpoint can tell the two runs apart."""
    frames = np.random.default_rng(1).integers(0, 255, size=(10, 56, 56, 3), dtype=np.uint8)
    data, vids = _write_manifest(tmp_path, [_video_item(i, "v.npy", "the same answer")
                                            for i in range(4)], {"v.npy": frames})
    extra = ("--gradient_accumulation_steps", "2", "--max_steps", "3", "--save_steps", "1",
             "--save_total_limit", "10", "--dropout_frames")
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    _run_port(monkeypatch, jax_params, _argv(data, vids, whole, *extra))

    class Stop(Exception):
        pass

    save = checkpoint_io.save_checkpoint

    def save_then_stop(ckpt_dir, state, step, **kw):
        path = save(ckpt_dir, state, step, **kw)
        if step == 3:
            checkpoint_io.wait_for_checkpoints()
            raise Stop
        return path

    monkeypatch.setattr(checkpoint_io, "save_checkpoint", save_then_stop)
    with pytest.raises(Stop):
        _run_port(monkeypatch, jax_params, _argv(data, vids, split, *extra))
    monkeypatch.setattr(checkpoint_io, "save_checkpoint", save)
    assert checkpoint_io.latest_checkpoint(split).endswith("checkpoint-3")
    _run_port(monkeypatch, jax_params, _argv(data, vids, split, *extra))
    got, want = _records(split), _records(whole)
    assert [r["step"] for r in got] == [1, 2, 3, 4, 5, 6]
    for g, w in zip(got, want):
        assert (g["step"], g["loss"], g["grad_norm"]) == (w["step"], w["loss"], w["grad_norm"])
    _assert_exports_match(split, whole, atol=0)
    # a finished run resumes at its end and trains no more
    _run_port(monkeypatch, jax_params, _argv(data, vids, split, *extra))
    assert len(_records(split)) == 6


def test_cli_with_int8_tower_matches_jax(mixed, tmp_path, monkeypatch, jax_params):
    """--tower_int8 over JAX's prequantized tower, one micro-step on two
    videos: the int8 leaves and their scales stay bit-identical through the
    optimizer, and the step follows JAX's."""
    data, vids = mixed
    videos = [item for item in json.load(open(data)) if "video" in item]
    data = str(tmp_path / "videos.json")
    with open(data, "w") as f:
        json.dump(videos, f)
    cfg = dataclasses.replace(TINY, pipeline=dataclasses.replace(TINY.pipeline, tower_int8=True))
    jp = dict(jax_params)
    jp["vision_tower"] = jax.tree.map(np.asarray, jsiglip.prequantize_int8(
        jax.tree.map(jnp.asarray, jax_params["vision_tower"])))
    pcfg = convert.config_from_fields(cfg)
    extra = ("--gradient_accumulation_steps", "1", "--max_steps", "1", "--save_steps", "1",
             "--tower_int8")
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    _run_port(monkeypatch, jp, _argv(data, vids, tout, *extra), pcfg)
    _run_jax(monkeypatch, jp, _argv(data, vids, jout, *extra), cfg)
    orbax_io.wait_for_checkpoints()
    assert len(_assert_records_match(tout, jout)) == 1
    tower0 = convert.from_jax_params(jp, pcfg, device="cpu")["vision_tower"]
    _, tcfg = _opt_cfgs(1, 1)
    state = checkpoint_io.restore_checkpoint(
        os.path.join(tout, "checkpoint-1"), ttrainer.init_train_state(
            convert.from_jax_params(jp, pcfg, device="cpu"), tcfg))
    n_int8 = 0
    for (path, a), (_, b) in zip(leaves_with_path(tower0),
                                 leaves_with_path(state.params["vision_tower"])):
        assert a.dtype == b.dtype and torch.equal(a, b), path_str(path)
        n_int8 += a.dtype == torch.int8
    assert n_int8 == 6 * PCFG.vision.num_used_layers


@pytest.mark.parametrize("argv,match", [
    (("--mesh_tp", "2"), "item 9"), (("--distributed",), "item 9"),
    (("--mesh_fsdp", "4"), "item 9"), (("--version", "nope"), "conversation templates"),
    (("--mm_projector_type", "linear"), "mlp2x_gelu"),
    (("--tower_int8", "--mm_tunable_parts", "mm_vision_tower"), "conflicts"),
])
def test_cli_refuses_what_it_cannot_run(mixed, tmp_path, monkeypatch, jax_params, argv, match):
    data, vids = mixed
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _run_port(monkeypatch, jax_params, _argv(data, vids, str(tmp_path / "o"), *argv))


def test_cli_without_a_card_or_weights_raises(mixed, tmp_path, monkeypatch):
    """No CPU fallback: the default build_model needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, vids = mixed
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(_argv(data, vids, str(tmp_path / "o")))
