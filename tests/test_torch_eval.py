"""The port's evaluation entries against the JAX package's, on the tiny
checkpoint of tests/test_builder_roundtrip.py, both loaded in fp32 on the
CPU (each package's `load_pretrained_model` wrapped with
`torch_dtype="float32"`: JAX's entries load bf16, whose rounding differs
between the frameworks).

- `load_pretrained_model(model_base=...)` is accepted and not read, in
  both packages; `device_preprocess=True` loads and answers a uint8 video
  with JAX's tokens;
- `eval/model_vqa.main` over a question file (a video, an image, text only,
  a ground-truth answer, a Q2 consistency pair, a missing video): every
  row's `output_ids`, text, prompt, `answer`, `pred2` and error equal to
  JAX's, with and without `--device_preprocess`; `get_chunk` and chunked
  runs as JAX's; the card by default;
- the lmms-eval adapter registered as `mavlm_torch` beside `mavlm_tpu` in
  the vendored registry, and through the vendored harness on image and
  video docs: `generate_until` (with `until` stops) with JAX's generated
  ids and responses, `loglikelihood` within 1e-4 and its picks equal,
  `generate_until_multi_round` equal;
- `eval_bridge.evaluate_checkpoint`: the `model_vqa` fallback with JAX's
  arguments, the lmms-eval command with `--model mavlm_torch`, the raise
  without a question file;
- `gpt_eval` and `evaluate_interleave`, copies, equal to the originals on
  the same inputs (the OpenAI judge's requests through a stub client);
- `predict.Predictor` with JAX's (the root `predict.py`) answers for a
  video, an image and text.
"""

import functools
import importlib
import json
import sys
import types

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from memory_augmented_vlm_tpu.eval import builder as jbuilder
from memory_augmented_vlm_tpu.eval import eval_bridge as jbridge
from memory_augmented_vlm_tpu.eval import evaluate_interleave as jinter
from memory_augmented_vlm_tpu.eval import gpt_eval as jgpt
from memory_augmented_vlm_tpu.eval import lmms_adapter as jlmms
from memory_augmented_vlm_tpu.eval import model_vqa as jvqa
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch import predict as tpredict
from memory_augmented_vlm_torch.eval import builder as tbuilder
from memory_augmented_vlm_torch.eval import eval_bridge as tbridge
from memory_augmented_vlm_torch.eval import evaluate_interleave as tinter
from memory_augmented_vlm_torch.eval import gpt_eval as tgpt
from memory_augmented_vlm_torch.eval import lmms_adapter as tlmms
from memory_augmented_vlm_torch.eval import model_vqa as tvqa
from memory_augmented_vlm_torch.utils.tree import leaves_with_path
from test_builder_roundtrip import ckpt_dir  # noqa: F401  (the tiny checkpoint)
from test_torch_checkpoint import assert_trees_equal

LL_RTOL = 1e-4
JLOAD = functools.partial(jbuilder.load_pretrained_model, torch_dtype="float32")
TLOAD = functools.partial(tbuilder.load_pretrained_model, torch_dtype="float32")


@pytest.fixture
def fp32(monkeypatch):
    """Every entry's loader in fp32 (the port's also on the CPU)."""
    cpu = functools.partial(TLOAD, device_map="cpu")
    for module, fn in ((jvqa, JLOAD), (jlmms, JLOAD), (jbuilder, JLOAD), (tvqa, TLOAD),
                       (tlmms, TLOAD), (tpredict, cpu)):
        monkeypatch.setattr(module, "load_pretrained_model", fn)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- builder

def test_model_base_is_accepted_and_ignored(ckpt_dir):  # noqa: F811
    _, jm, _, _ = JLOAD(ckpt_dir, "anything", "llava_qwen")
    _, tm, _, _ = TLOAD(ckpt_dir, "anything", "llava_qwen", device_map="cpu")
    _, plain, _, _ = TLOAD(ckpt_dir, None, "llava_qwen", device_map="cpu")
    assert_trees_equal(tm.params, plain.params)
    want = convert.from_jax_params(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    assert_trees_equal(tm.params, want)


def test_device_preprocess_loads_and_matches_jax(ckpt_dir):  # noqa: F811
    _, jm, _, _ = JLOAD(ckpt_dir, device_preprocess=True)
    _, tm, _, _ = TLOAD(ckpt_dir, device_preprocess=True, device_map="cpu")
    assert tm.device_preprocess and jm.device_preprocess
    frames = _rng(0).integers(0, 256, (12, 60, 80, 3), dtype=np.uint8)
    ids = np.array([[10, 20, constants.IMAGE_TOKEN_INDEX, 30]], np.int64)
    kw = dict(images=[frames], modalities=["video"], max_new_tokens=5)
    np.testing.assert_array_equal(tm.generate(ids, **kw), np.asarray(jm.generate(ids, **kw)))


# ------------------------------------------------------------- model_vqa

@pytest.fixture(scope="module")
def questions(tmp_path_factory):
    d = tmp_path_factory.mktemp("vqa")
    (d / "videos").mkdir()
    (d / "images").mkdir()
    np.save(d / "videos" / "a.npy", _rng(1).integers(0, 256, (8, 56, 56, 3), dtype=np.uint8))
    np.save(d / "videos" / "b.npy", _rng(2).integers(0, 256, (5, 40, 72, 3), dtype=np.uint8))
    Image.fromarray(_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
        d / "images" / "c.png")
    rows = [
        {"question_id": 1, "video": "a.npy", "text": "what happens?", "answer": "a cat"},
        {"question_id": 2, "image": "c.png", "text": "what is this?"},
        {"question_id": 3, "text": "hello?"},
        {"id": 4, "video": "b.npy", "Q1": "who?", "Q2": "which person?", "A": "a man"},
        {"question_id": 5, "video": "missing.npy", "text": "lost"},
    ]
    (d / "q.jsonl").write_text("\n".join(json.dumps(q) for q in rows))
    return d


def _vqa(main, ckpt, d, out, *extra):
    main(["--model-path", str(ckpt), "--question-file", str(d / "q.jsonl"),
          "--video-folder", str(d / "videos"), "--image-folder", str(d / "images"),
          "--answers-file", str(out), "--max_new_tokens", "5", *extra])
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--device_preprocess"]], ids=["host", "device"])
def test_model_vqa_matches_jax(fp32, ckpt_dir, questions, tmp_path, extra):  # noqa: F811
    want = _vqa(jvqa.main, ckpt_dir, questions, tmp_path / "jax.jsonl", *extra)
    got = _vqa(tvqa.main, ckpt_dir, questions, tmp_path / "torch.jsonl", "--device-map", "cpu",
               *extra)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if "error" in w:
            assert g["question_id"] == w["question_id"] == 5 and g["text"] == ""
            assert "error" in g and "missing.npy" in g["error"]
            continue
        assert g == w
    assert got[0]["answer"] == "a cat" and got[3]["answer"] == "a man" and "pred2" in got[3]
    assert got[0]["prompt"].startswith(constants.DEFAULT_IMAGE_TOKEN + "\n")
    assert any(len(set(r["output_ids"])) > 1 for r in got[:4])


def test_model_vqa_chunks_and_card_default(fp32, ckpt_dir, questions, tmp_path,  # noqa: F811
                                           monkeypatch):
    for n, k in ((3, 0), (3, 2), (2, 1), (1, 0)):
        xs = list(range(10))
        assert tvqa.get_chunk(xs, n, k) == jvqa.get_chunk(xs, n, k)
    assert sum((tvqa.get_chunk(list(range(10)), 3, k) for k in range(3)), []) == list(range(10))
    got = _vqa(tvqa.main, ckpt_dir, questions, tmp_path / "chunk.jsonl", "--device-map", "cpu",
               "--num-chunks", "2", "--chunk-idx", "1")
    assert [r["question_id"] for r in got] == [4, 5]
    monkeypatch.setattr(tvqa, "load_pretrained_model", TLOAD)  # no device_map given
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _vqa(tvqa.main, ckpt_dir, questions, tmp_path / "card.jsonl")


# ---------------------------------------------------------- lmms adapter

@pytest.fixture(scope="module")
def adapters(ckpt_dir):  # noqa: F811
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlmms, "load_pretrained_model", JLOAD)
        mp.setattr(tlmms, "load_pretrained_model", TLOAD)
        return (jlmms.MavlmTpu(pretrained=ckpt_dir, max_frames_num=8),
                tlmms.MavlmTorch(pretrained=ckpt_dir, max_frames_num=8, device="cpu"))


def _recording(adapter):
    """The ids each `model.generate` call of `adapter` returned."""
    seen = []
    generate = adapter.model.generate

    def record(*args, **kwargs):
        out = np.asarray(generate(*args, **kwargs))
        seen.append(out.tolist())
        return out

    adapter.model.generate = record
    return seen


def _docs():
    rng = _rng(4)
    return [{"doc_id": 0, "question": "what is shown?", "answer": "A",
             "visual": [Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))]},
            {"doc_id": 1, "question": "what happens?", "answer": "B",
             "visual": [rng.integers(0, 256, (12, 56, 56, 3), dtype=np.uint8)]}]


def _task(adapter, **kw):
    from lmms_eval import evaluate_task

    return evaluate_task(adapter, "tiny", _docs(), doc_to_text=lambda d: d["question"],
                         doc_to_visual=lambda d: d["visual"],
                         doc_to_target=lambda d: d["answer"], **kw)


def test_adapter_registered_beside_jax(adapters):
    from lmms_eval.api.registry import MODEL_REGISTRY, get_model

    assert tlmms._HAVE_LMMS and jlmms._HAVE_LMMS
    assert get_model("mavlm_torch") is tlmms.MavlmTorch
    assert get_model("mavlm_tpu") is jlmms.MavlmTpu
    assert isinstance(adapters[1].model.params["language_model"]["embed_tokens"], torch.Tensor)
    assert {"mavlm_torch", "mavlm_tpu"} <= set(MODEL_REGISTRY)


def test_adapter_generate_until_matches_jax(adapters):
    ja, ta = adapters
    jids, tids = _recording(ja), _recording(ta)
    kw = dict(request_type="generate_until",
              gen_kwargs={"max_new_tokens": 5, "temperature": 0, "until": ["\n", "</s>"]})
    want, got = _task(ja, **kw), _task(ta, **kw)
    assert got == want and len(got["responses"]) == 2
    assert tids == jids and len(tids) == 2


def test_adapter_loglikelihood_matches_jax(adapters):
    ja, ta = adapters
    # continuations the fixture's tokenizer encodes (it drops characters
    # its corpus lacks, and an empty continuation scores (0.0, True))
    choices = [" a cat", " hello world", " what is here"]
    kw = dict(request_type="loglikelihood", choices=lambda d: choices)
    assert _task(ta, **kw)["responses"] == _task(ja, **kw)["responses"]
    for doc in _docs():
        vis = np.stack([np.asarray(v) for v in doc["visual"]]) \
            if isinstance(doc["visual"][0], Image.Image) else doc["visual"][0]
        modality = "image" if isinstance(doc["visual"][0], Image.Image) else "video"
        for cont in choices:
            want = ja.score(doc["question"], cont, visuals=vis, modality=modality)
            got = ta.score(doc["question"], cont, visuals=vis, modality=modality)
            assert got[1] == want[1] and got[0] < 0
            np.testing.assert_allclose(got[0], want[0], rtol=LL_RTOL)
    assert ta.score("hi", "") == (0.0, True)


def test_adapter_multi_round_matches_jax(adapters):
    from lmms_eval.api.instance import Instance

    outs = []
    for adapter in adapters:
        doc = _docs()[0]
        adapter.task_dict = {"mr": {"test": {0: doc}}}
        req = Instance(request_type="generate_until_multi_round",
                       arguments=(["what is this?", "and why?"],
                                  {"max_new_tokens": 4, "temperature": 0},
                                  lambda d: d["visual"], 0, "mr", "test"),
                       idx=0, metadata=("mr", 0, 1))
        seen = _recording(adapter)
        outs.append((adapter.generate_until_multi_round([req]), seen))
    assert outs[1] == outs[0] and len(outs[1][0][0]) == 2


# ------------------------------------------------------------ eval_bridge

def test_eval_bridge_fallback_and_command(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(jvqa, "main", lambda argv: calls.append(("jax", argv)))
    monkeypatch.setattr(tvqa, "main", lambda argv: calls.append(("torch", argv)))
    kw = dict(question_file="q.jsonl", video_folder="v", max_frames_num=16)
    a = jbridge.evaluate_checkpoint("ckpt", output_dir=str(tmp_path / "j"), **kw)
    b = tbridge.evaluate_checkpoint("ckpt", output_dir=str(tmp_path / "t"), **kw)
    assert b == str(tmp_path / "t" / "answers.jsonl")
    (_, ja), (_, ta) = calls
    assert ta == [x.replace(str(tmp_path / "j"), str(tmp_path / "t")) for x in ja]
    with pytest.raises(RuntimeError, match="question_file"):
        tbridge.evaluate_checkpoint("ckpt", output_dir=str(tmp_path / "t"))
    # an installed lmms-eval runs the harness with the port's adapter
    runs = []
    for module in (jbridge, tbridge):
        monkeypatch.setattr(module.shutil, "which", lambda name: "/bin/lmms-eval")
        monkeypatch.setattr(module.subprocess, "run", lambda cmd, check: runs.append(cmd))
    jbridge.evaluate_checkpoint("ckpt", output_dir=str(tmp_path))
    tbridge.evaluate_checkpoint("ckpt", output_dir=str(tmp_path))
    assert runs[1] == [("mavlm_torch" if x == "mavlm_tpu" else x) for x in runs[0]]
    assert "mavlm_torch" in runs[1]


# ----------------------------------------------------- judges and metrics

PREDS = [
    {"question_id": 1, "question": "what colour is the car?", "answer": "red",
     "text": "The car is red.", "pred2": "red"},
    {"question_id": 2, "prompt": "<image>\nwho runs?", "answer": "a tall man",
     "pred": "a man runs", "pred2": "nobody"},
    {"question_id": 3, "question": "count?", "answer": "three", "text": ""},
]


@pytest.mark.parametrize("mode", ["qa", "correctness", "detailed_orientation", "context",
                                  "temporal", "consistency"])
def test_gpt_eval_evaluate_matches_jax(mode):
    assert tgpt.evaluate(PREDS, mode, tgpt.offline_judge) == \
        jgpt.evaluate(PREDS, mode, jgpt.offline_judge)


def test_gpt_eval_parts_match_jax(tmp_path):
    for a, b in (("the red car", "a red car!"), ("", ""), ("x", ""), ("a b a", "a a c")):
        assert tgpt.token_f1(a, b) == jgpt.token_f1(a, b)
    for reply in ("{'pred': 'Yes', 'score': 4}", "sure: {'score': 2.5}", '{"pred": "no"}'):
        assert tgpt.parse_judge_reply(reply) == jgpt.parse_judge_reply(reply)
    with pytest.raises(ValueError):
        tgpt.parse_judge_reply("no dict here")
    assert tgpt.qa_messages("q", "a", "p") == jgpt.qa_messages("q", "a", "p")
    for axis in tgpt._AXES:
        assert tgpt.axis_messages(axis, "q", "a", "p", "p2") == \
            jgpt.axis_messages(axis, "q", "a", "p", "p2")
    # ActivityNet's id-keyed question and answer files; a directory of chunks
    gq, ga = tmp_path / "gq.json", tmp_path / "ga.json"
    gq.write_text(json.dumps([{"question_id": 3, "question": "how many?"}]))
    ga.write_text(json.dumps([{"id": 3, "answer": "three"}, {"id": 1, "answer": "blue"}]))
    assert tgpt.attach_gt(PREDS, str(gq), str(ga)) == jgpt.attach_gt(PREDS, str(gq), str(ga))
    chunks = tmp_path / "chunks"
    chunks.mkdir()
    for i, p in enumerate(PREDS):
        (chunks / f"{i}.jsonl").write_text(json.dumps(p) + "\n")
    (tmp_path / "all.json").write_text(json.dumps(PREDS))
    for path in (chunks, tmp_path / "all.json"):
        assert tgpt.load_preds(str(path)) == jgpt.load_preds(str(path)) == PREDS
    outs = []
    for module in (jgpt, tgpt):
        out = tmp_path / f"{module.__name__}.json"
        res = module.main(["--pred_path", str(chunks), "--mode", "qa", "--gt_file_question",
                           str(gq), "--gt_file_answers", str(ga), "--output_json", str(out)])
        outs.append((res, json.loads(out.read_text())))
    assert outs[1] == outs[0] and outs[1][0]["judge"] == "offline-token-f1(heuristic)"


def test_openai_judge_sends_jax_requests(monkeypatch):
    sent = []

    class Client:
        def __init__(self, api_key):
            self.chat = types.SimpleNamespace(completions=self)
            self.key = api_key

        def create(self, model, messages):
            sent.append((self.key, model, messages))
            msg = types.SimpleNamespace(content="{'pred': 'yes', 'score': 5}")
            return types.SimpleNamespace(choices=[types.SimpleNamespace(message=msg)])

    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=Client))
    msgs = tgpt.axis_messages("consistency", "q", "a", "p", "p2")
    got = tgpt.openai_judge("k", "judge-model")(msgs)
    want = jgpt.openai_judge("k", "judge-model")(msgs)
    assert got == want == {"pred": "yes", "score": 5.0}
    assert sent[0] == sent[1] == ("k", "judge-model", msgs)
    assert msgs[0]["role"] == "system" and msgs[1]["role"] == "user"


INTERLEAVE = [
    {"dataset": "Spot-the-Diff", "text": "The left image has a red car.",
     "answer": "a red car on the left"},
    {"dataset": "NLVR2_Mantis", "prediction": "A", "answer": "true", "choices": ["true", "false"]},
    {"dataset": "QBench", "question_type": "multi-choice", "prediction": "the image is blurry",
     "answer": "blurry", "choices": ["sharp", "blurry"]},
    {"dataset": "RAVEN", "question_type": "multi-choice", "prediction": "b",
     "answer": "two", "choices": ["one", "two"]},
    {"dataset": "unknown", "text": "", "answer": "x"},
]


def test_evaluate_interleave_matches_jax(tmp_path, capsys):
    for a in ("The Car, a red one!", "an apple", "", "  A  B "):
        assert tinter.normalize_answer(a) == jinter.normalize_answer(a)
        assert tinter.rouge_l_f(a, "a red car") == jinter.rouge_l_f(a, "a red car")
    for p in INTERLEAVE:
        args = (p.get("prediction", p.get("text", "")), p["answer"], p.get("choices", []))
        assert tinter.judge_multi_choice(*args) == jinter.judge_multi_choice(*args)
    assert tinter.evaluate(INTERLEAVE) == jinter.evaluate(INTERLEAVE)
    assert tinter.CATEGORIES == jinter.CATEGORIES
    d = tmp_path / "res"
    d.mkdir()
    for i, p in enumerate(INTERLEAVE):
        (d / f"{i}.jsonl").write_text(json.dumps(p) + "\n")
    outs = []
    for module in (jinter, tinter):
        out = tmp_path / f"{module.__name__}.json"
        module.main(["--result-dir", str(d), "--output", str(out)])
        outs.append((capsys.readouterr().out, json.loads(out.read_text())))
    assert outs[1] == outs[0] and "overall" in outs[1][1]


# -------------------------------------------------------------- Predictor

def test_predictor_matches_jax(fp32, ckpt_dir, tmp_path):  # noqa: F811
    jpredict = importlib.import_module("predict")
    jp, tp = jpredict.Predictor(), tpredict.Predictor()
    jp.setup(ckpt_dir)
    tp.setup(ckpt_dir, device_map="cpu")
    assert tp.context_len == jp.context_len
    video = tmp_path / "clip.npy"
    np.save(video, _rng(5).integers(0, 256, (6, 56, 56, 3), dtype=np.uint8))
    image = tmp_path / "img.png"
    Image.fromarray(_rng(6).integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(image)
    jids, tids = _recording(jp), _recording(tp)
    for kw in (dict(video=str(video)), dict(image=str(image)), {}):
        assert tp.predict("what is it?", max_new_tokens=5, **kw) == \
            jp.predict("what is it?", max_new_tokens=5, **kw)
    assert tids == jids and len(tids) == 3
    assert {x.dtype for _, x in leaves_with_path(tp.model.params)} == {torch.float32}
