"""The port's serving benchmark entries (`memory_augmented_vlm_torch.
bench_serving` and `.bench_throughput`) against the root `bench_serving.py`
and `bench_throughput.py`, on the CPU at tiny configurations: their
measurement loops and JSON builders run, their JSON keys are the root
scripts' less the relay fields, and `main` raises without a CUDA card (the
benchmarks never run on the CPU)."""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from memory_augmented_vlm_torch import bench_serving, bench_throughput, convert, pipeline
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.models import vlm
from test_torch_serve_engine import PCFG, running, tiny_params
from test_vlm import TINY

ROOT = Path(__file__).resolve().parent.parent
RELAY = {"dispatch_floor_ms", "device_ms_per_round", "projected_tokens_per_s_1ms_dispatch"}


def _root_lines(script: str):
    """The keys and string values of each JSON line the root script prints
    (the dict literals inside its `json.dumps(` calls)."""
    source = (ROOT / script).read_text()
    lines = []
    for start in [m.end() for m in re.finditer(r"json\.dumps\(\{", source)]:
        depth, i = 1, start
        while depth:
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            i += 1
        block = source[start:i]
        lines.append((set(re.findall(r'"(\w+)":', block)),
                      set(re.findall(r'"metric": "([\w.]+)"', block))))
    return lines


def _keys(line: dict) -> set:
    return set(line) | set(line["detail"])


@pytest.mark.parametrize("flags", [[], ["--kv_int8", "--decode_ticks", "2"],
                                   ["--paged_page_size", "16", "--chunk_prefill", "8"]],
                         ids=["default", "kv_int8_multi_tick", "paged_chunked"])
def test_bench_serving_line_on_a_tiny_lm(flags):
    """`measure` and `result` over a started engine: every slot's first
    token, then (decode_tokens - 1) more each (the tiny vocab never meets
    the eos id), in bench_serving.py's keys less the relay fields."""
    (root_keys, root_metrics), = _root_lines("bench_serving.py")
    args = bench_serving.parse_args(["--num_slots", "2", "--max_len", "64", "--prompt_len",
                                     "20", "--decode_tokens", "6", *flags])
    _, tp = tiny_params()
    with running(bench_serving.make_engine(tp, PCFG, args)) as engine:
        measured = bench_serving.measure(engine, tp["language_model"], args,
                                         np.random.default_rng(0))
    out = bench_serving.result(args, measured, "cpu (test)")
    assert _keys(out) == root_keys - RELAY and {out["metric"]} == root_metrics
    detail = out["detail"]
    assert detail["first_tokens"] == 2 and detail["decode_tokens_timed"] == 2 * 5
    assert detail["backend"] == "cpu (test)" and detail["decode_rounds_timed"] > 0
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert detail["engine_stats"]["tokens"] == 12


def _tiny_stream(num_clips=2, frames=4):
    cfg = convert.config_from_fields(TINY)
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, tower_int8=True))
    params = pipeline.int8_serving_params(vlm.init_params(cfg, seed=0, device="cpu"))
    fn, _ = pipeline.build_pipeline(cfg, frames, kv_int8=True, max_new_tokens=3)
    side = cfg.vision.image_size
    clips = bench_throughput.raw_clips(num_clips, frames, 2 * side)
    text = dict(text_before=[11, 872, 198], text_after=[3838, 374, 12482])
    return bench_throughput.Stream(fn, params, clips, SigLipImageProcessor(size=(side, side)),
                                   "cpu", dtype=torch.float32, **text)


@pytest.mark.parametrize("synthetic", [True, False], ids=["synthetic_producer", "all_modes"])
def test_bench_throughput_line_on_a_tiny_model(synthetic):
    """Every mode of the root script over two clips of a tiny int8 VLM
    (frames at twice the tower's side, so both processors resize), in its
    metric names and keys."""
    root = {frozenset(m): keys for keys, m in _root_lines("bench_throughput.py")}
    out = bench_throughput.measure(_tiny_stream(), synthetic)
    assert _keys(out) == root[frozenset({out["metric"]})]
    assert out["metric"] == ("sustained_clips_per_s_64frame_0.5b_synthetic_producer"
                             if synthetic else "pipelined_clip_throughput_64frame_0.5b")
    assert out["detail"]["clips"] == 2
    assert math.isfinite(out["value"]) and out["value"] > 0
    # both are rounded to 3 places from the unrounded clips/s
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / bench_throughput.baseline_clips_per_s(), abs=1e-3)


def test_bench_throughput_baseline_is_bench_throughput_py_figure():
    """16500 visual tokens/s (the modeled A100 at 64 frames) over 9429
    visual tokens a clip, as the root script divides them."""
    assert bench_throughput.baseline_clips_per_s() == 16500.0 / 9429
    source = (ROOT / "bench_throughput.py").read_text()
    assert "VISUAL_TOKENS_PER_CLIP = 9429" in source and "NUM_CLIPS = 8" in source
    assert bench_throughput.NUM_CLIPS == 8 and pipeline.NUM_FRAMES == 64


@pytest.mark.parametrize("entry,argv", [(bench_serving, []), (bench_throughput, []),
                                        (bench_throughput, ["--synthetic-producer"])])
def test_entries_need_a_card(monkeypatch, entry, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(argv)
