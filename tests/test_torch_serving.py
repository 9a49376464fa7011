"""The port's serving HTTP stack (`memory_augmented_vlm_torch/serve/`) against
the JAX package's, on the tiny checkpoint of tests/test_builder_roundtrip.py,
both packages' loaders wrapped with `torch_dtype="float32"` (JAX's workers
load bf16, whose rounding differs between the frameworks) and the port's
workers on the CPU (`device_map="cpu"`).

- JAX's serving tests on the port: a controller, three workers (plain,
  `device_preprocess`, the engine-backed one) and the web UI over HTTP on
  127.0.0.1: list and dispatch, an unknown model, a message through the
  controller's proxy, the heartbeat, the incremental stream, the page, the
  templates, `/chat`'s ndjson, a video payload, device preprocess with
  same-size and mixed-size frames;
- held to JAX: each worker's chunks (bytes) and token ids on the same
  payloads (the ids recorded by wrapping the token source: the tiny
  tokenizer decodes ids past its 2000 entries to ""), `_render_prompt` for
  every template, the lottery's picks under one seed and shortest-queue
  dispatch, the heartbeat expiry, `cli.main`'s printed answers and ids;
- the card by default: the workers and the CLI raise without one unless
  they are asked for the CPU.
"""

import base64
import builtins
import contextlib
import functools
import io
import json
import re
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from memory_augmented_vlm_tpu.data.conversation import conv_templates as jtemplates
from memory_augmented_vlm_tpu.eval import builder as jbuilder
from memory_augmented_vlm_tpu.eval import model as jmodel
from memory_augmented_vlm_tpu.serve import cli as jcli
from memory_augmented_vlm_tpu.serve import controller as jctrl
from memory_augmented_vlm_tpu.serve import model_worker as jmw
from memory_augmented_vlm_tpu.serve import sglang_worker as jsg
from memory_augmented_vlm_tpu.serve import web_server as jweb
from memory_augmented_vlm_torch.data.conversation import conv_templates as ttemplates
from memory_augmented_vlm_torch.eval import model as tmodel
from memory_augmented_vlm_torch.serve import cli as tcli
from memory_augmented_vlm_torch.serve import client
from memory_augmented_vlm_torch.serve import controller as tctrl
from memory_augmented_vlm_torch.serve import model_worker as tmw
from memory_augmented_vlm_torch.serve import sglang_worker as tsg
from memory_augmented_vlm_torch.serve import web_server as tweb
from test_builder_roundtrip import ckpt_dir  # noqa: F401  (the tiny checkpoint)

NAMES = {"plain": "tiny-mavlm", "device": "tiny-mavlm-dp", "engine": "tiny-mavlm-engine"}
ENGINE_KW = dict(num_slots=2, max_len=256)


def _b64_png(frame: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _frames(seed: int, n: int, hw) -> list:
    rng = np.random.default_rng(seed)
    return [_b64_png(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)) for _ in range(n)]


VIDEO = _frames(0, 3, (56, 56))
SMALL = _frames(1, 3, (40, 30))
MIXED = SMALL + _frames(2, 1, (56, 56))
IMAGE = _frames(3, 1, (48, 64))
PAYLOADS = {  # (worker, payload)
    "text": ("plain", {"prompt": "hello world", "max_new_tokens": 12}),
    "video": ("plain", {"prompt": "<image>\ndescribe", "images": VIDEO, "max_new_tokens": 12}),
    "image": ("plain", {"prompt": "<image>\nwhat is here", "images": IMAGE,
                        "max_new_tokens": 10}),
    "stop": ("plain", {"prompt": "a cat sits", "max_new_tokens": 12, "stop": "hello"}),
    "device": ("device", {"prompt": "<image>\ndescribe", "images": SMALL,
                          "max_new_tokens": 12}),
    "mixed": ("device", {"prompt": "<image>\ndescribe", "images": MIXED,
                         "max_new_tokens": 12}),
    "bad_image": ("plain", {"prompt": "<image>\ndescribe", "images": ["bm90IGEgcG5n"],
                            "max_new_tokens": 4}),
    "bad_base64": ("engine", {"prompt": "<image>\ndescribe", "images": ["bm90I"],
                              "max_new_tokens": 4}),
    "engine_text": ("engine", {"prompt": "hello world", "max_new_tokens": 12}),
    "engine_video": ("engine", {"prompt": "<image>\ndescribe", "images": VIDEO,
                                "max_new_tokens": 12}),
    "engine_stop": ("engine", {"prompt": "what is here", "max_new_tokens": 8,
                               "stop": ["x", "hello"]}),
}


def _record_ids(worker):
    """Wrap the worker's token source so that each request's token ids are
    appended to `worker.ids`: the model's `generate_stream`, or the queue
    the engine hands back."""
    worker.ids = []
    if hasattr(worker, "engine"):
        submit = worker.engine.submit

        def recorded_submit(*args, **kwargs):
            out = submit(*args, **kwargs)

            def get():
                item = out.get(timeout=120)
                if item is not None:
                    worker.ids.extend(int(t) for t in item)
                return item
            return types.SimpleNamespace(get=get)
        worker.engine.submit = recorded_submit
    else:
        stream = worker.model.generate_stream

        def recorded_stream(*args, **kwargs):
            for ids in stream(*args, **kwargs):
                worker.ids.extend(int(t) for t in ids)
                yield ids
        worker.model.generate_stream = recorded_stream
    return worker


def _masked(chunks: list) -> list:
    """Chunks with object addresses masked (PIL names its stream in an
    error: `<_io.BytesIO object at 0x...>`)."""
    return [re.sub(rb"0x[0-9a-f]+", b"0x?", c) for c in chunks]


def _run(worker, payload) -> tuple:
    """(chunks as bytes, token ids) of one request straight to the worker."""
    worker.ids.clear()
    chunks = list(worker.generate_stream(payload))
    return chunks, list(worker.ids)


@pytest.fixture(scope="module")
def fp32():
    """Every loader the stack reaches in fp32 for the module."""
    mp = pytest.MonkeyPatch()
    jload = functools.partial(jbuilder.load_pretrained_model, torch_dtype="float32")
    tload = functools.partial(tmw.load_pretrained_model, torch_dtype="float32")
    mp.setattr(jbuilder, "load_pretrained_model", jload)
    mp.setattr(jcli, "load_pretrained_model", jload)
    mp.setattr(tmw, "load_pretrained_model", tload)
    mp.setattr(tcli, "load_pretrained_model", tload)
    yield
    mp.undo()


def _workers(mw, sg, ckpt, **cpu):
    return {"plain": _record_ids(mw.ModelWorker(None, "local", ckpt, NAMES["plain"],
                                                register=False, **cpu)),
            "device": _record_ids(mw.ModelWorker(None, "local", ckpt, NAMES["device"],
                                                 register=False, device_preprocess=True,
                                                 **cpu)),
            "engine": _record_ids(sg.SGLangWorker(None, "local", ckpt, NAMES["engine"],
                                                  register=False, **ENGINE_KW, **cpu))}


@pytest.fixture(scope="module")
def jax_workers(fp32, ckpt_dir):  # noqa: F811
    workers = _workers(jmw, jsg, ckpt_dir)
    yield workers
    workers["engine"].engine.shutdown()


def _serve(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def stack(fp32, ckpt_dir):  # noqa: F811
    """The port's controller, its three workers registered by hand (as JAX's
    test does: a registered worker's heartbeat thread would hold it), and
    the web UI, each on an ephemeral port."""
    servers = [tctrl.serve("127.0.0.1", 0)]
    ctrl = _serve(servers[0])
    workers = _workers(tmw, tsg, ckpt_dir, device_map="cpu")
    for worker in workers.values():
        servers.append(ThreadingHTTPServer(("127.0.0.1", 0), tmw.make_handler(worker)))
        worker.controller_addr, worker.worker_addr = ctrl, _serve(servers[-1])
        worker.register_to_controller()
    servers.append(ThreadingHTTPServer(("127.0.0.1", 0), tweb.make_handler(ctrl)))
    web = _serve(servers[-1])
    # the workers' heartbeats, every 5 s: the controller drops a worker 30 s
    # after its last, and the module may outlast that on a loaded machine
    stop = threading.Event()

    def beat():
        while not stop.wait(5.0):
            for w in workers.values():
                w._post("/receive_heart_beat", {"worker_name": w.worker_addr,
                                                "queue_length": w.queue_length})
    beating = threading.Thread(target=beat, daemon=True)
    beating.start()
    yield types.SimpleNamespace(ctrl=ctrl, web=web, workers=workers)
    stop.set()
    beating.join(timeout=30)
    workers["engine"].engine.shutdown()
    for server in servers:
        server.shutdown()
        server.server_close()


def _stream(stack, kind: str, prompt: str, **kwargs) -> list:
    """A request through the controller to the worker `kind`, its token ids
    recorded afresh."""
    stack.workers[kind].ids.clear()
    return list(client.stream_generate(stack.ctrl, NAMES[kind], prompt, **kwargs))


def _post(url: str, payload) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


# ------------------------------------------------------------ JAX's cases

def test_list_models_and_dispatch(stack):
    models = client.post_json(stack.ctrl + "/list_models", {})["models"]
    assert models == sorted(NAMES.values())
    addr = client.post_json(stack.ctrl + "/get_worker_address",
                            {"model": NAMES["plain"]})["address"]
    assert addr == stack.workers["plain"].worker_addr
    assert addr.startswith("http://127.0.0.1:")


def test_unknown_model(stack):
    assert client.post_json(stack.ctrl + "/get_worker_address", {"model": "nope"}) == \
        {"address": ""}
    assert list(client.stream_generate(stack.ctrl, "nope", "hi")) == []
    assert json.loads(_post(stack.ctrl + "/worker_generate_stream", {"model": "nope"})) == \
        {"text": "", "error_code": 2}
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _post(stack.ctrl + "/nowhere", {})


def test_message_through_stack(stack, jax_workers):
    outs = _stream(stack, "plain", "hello world", max_new_tokens=3)
    assert outs and all(o["error_code"] == 0 for o in outs)
    assert outs[-1]["text"].startswith("hello world")
    want, ids = _run(jax_workers["plain"], {"prompt": "hello world", "max_new_tokens": 3,
                                            "images": [], "temperature": 0.0})
    assert [json.loads(c[:-1]) for c in want] == outs
    assert stack.workers["plain"].ids == ids and len(ids) == 3


def test_heartbeat_updates_queue(stack):
    name = stack.workers["plain"].worker_addr
    ok = client.post_json(stack.ctrl + "/receive_heart_beat",
                          {"worker_name": name, "queue_length": 0})
    assert ok["exist"]
    assert not client.post_json(stack.ctrl + "/receive_heart_beat",
                                {"worker_name": "http://gone", "queue_length": 0})["exist"]


def test_worker_status(stack):
    worker = stack.workers["device"]
    status = json.loads(_post(worker.worker_addr + "/worker_get_status", {}))
    assert status == {"model_names": [NAMES["device"]], "speed": 1.0, "queue_length": 0}


def test_streaming_is_incremental(stack):
    """Several growing chunks (TextIteratorStreamer semantics), one a
    decode chunk of 8 tokens, not one final blob."""
    outs = _stream(stack, "plain", "tell me something", max_new_tokens=24)
    assert all(o["error_code"] == 0 for o in outs)
    assert len(outs) == 3 and len(stack.workers["plain"].ids) == 24
    texts = [o["text"] for o in outs]
    for a, b in zip(texts, texts[1:]):
        assert b.startswith(a[:len("tell me something")])
    assert len(texts[-1]) >= len(texts[0])


def test_web_ui_page_and_templates(stack):
    with urllib.request.urlopen(stack.web + "/", timeout=10) as r:
        page = r.read().decode()
    assert "mavlm_torch chat" in page and "regenerate" in page
    assert page == jweb._PAGE.replace("mavlm_tpu chat", "mavlm_torch chat")
    t = client.post_json(stack.web + "/templates", {})
    assert t == {"templates": sorted(jtemplates), "default_name": "qwen_1_5"}
    assert "qwen_1_5" in t["templates"] and len(t["templates"]) >= 21


def test_web_ui_proxies(stack):
    assert client.post_json(stack.web + "/proxy/list_models", {}) == \
        {"models": sorted(NAMES.values())}
    last = client.post_json(stack.web + "/proxy/worker_generate_stream",
                            {"model": NAMES["plain"], "prompt": "hi", "max_new_tokens": 3})
    assert last["error_code"] == 0 and last["text"].startswith("hi")


def test_web_ui_chat_streams_ndjson(stack, jax_workers):
    """/chat renders the prompt, streams the worker's chunks as ndjson with
    the echo stripped: the lines of JAX's worker on the same prompt."""
    history = [[0, "hi there"]]
    body = {"model": NAMES["plain"], "template": "qwen_1_5", "history": history,
            "images": [], "temperature": 0.0, "max_new_tokens": 12}
    stack.workers["plain"].ids.clear()
    lines = [json.loads(line) for line in _post(stack.web + "/chat", body).splitlines()
             if line.strip()]
    assert lines and all(line["error_code"] == 0 for line in lines)
    assert not lines[-1]["text"].startswith("<|im_start|>")
    prompt = jweb._render_prompt("qwen_1_5", history, 0)
    want, ids = _run(jax_workers["plain"], {"prompt": prompt, "images": [],
                                            "max_new_tokens": 12})
    assert lines == [{"text": json.loads(c[:-1])["text"][len(prompt):], "error_code": 0}
                     for c in want]
    assert stack.workers["plain"].ids == ids and len(ids) == 12


def test_web_ui_chat_without_worker(stack):
    lines = _post(stack.web + "/chat", {"model": "nope", "history": [[0, "hi"]]}).splitlines()
    assert [json.loads(line) for line in lines] == [{"text": "no worker for model",
                                                     "error_code": 2}]


def test_web_ui_serves_page_and_proxies():
    """A web UI over a controller with no worker."""
    ctrl = tctrl.serve("127.0.0.1", 0)
    ui = ThreadingHTTPServer(("127.0.0.1", 0), tweb.make_handler(_serve(ctrl)))
    try:
        ui_addr = _serve(ui)
        page = urllib.request.urlopen(ui_addr, timeout=10).read().decode()
        assert "mavlm_torch chat" in page
        req = urllib.request.Request(ui_addr + "/proxy/list_models", data=b"{}")
        assert json.loads(urllib.request.urlopen(req, timeout=10).read()) == {"models": []}
    finally:
        for server in (ui, ctrl):
            server.shutdown()
            server.server_close()


def test_web_ui_prompt_rendering_multi_image():
    out = tweb._render_prompt("qwen_1_5", [[0, "compare these"]], num_images=2)
    assert out.count("<image>") == 2
    assert out.endswith("<|im_start|>assistant\n")


def test_worker_video_base64_path(stack):
    """A multi-image base64 payload is a video."""
    outs = _stream(stack, "plain", "<image>\ndescribe", images=VIDEO, max_new_tokens=3)
    assert outs and all(o["error_code"] == 0 for o in outs)
    assert len(stack.workers["plain"].ids) == 3


@pytest.mark.parametrize("images", [SMALL, MIXED], ids=["same_size", "mixed_sizes"])
def test_worker_device_preprocess_video(stack, images):
    """`device_preprocess`: same-size frames go to the model as raw uint8;
    mixed sizes through the host processor (which resizes each frame before
    stacking) instead of failing on a ragged stack."""
    worker = stack.workers["device"]
    seen = []
    row_embeds = worker.model._row_embeds
    worker.model._row_embeds = lambda ids, img, *a: seen.append(img) or row_embeds(ids, img, *a)
    try:
        outs = _stream(stack, "device", "<image>\ndescribe", images=images, max_new_tokens=3)
    finally:
        del worker.model._row_embeds
    assert outs and all(o["error_code"] == 0 for o in outs)
    assert len(worker.ids) == 3
    (pixels,) = seen
    if images is SMALL:
        assert pixels.dtype == np.uint8 and pixels.shape == (3, 40, 30, 3)
    else:
        assert pixels.dtype == np.float32 and pixels.shape == (4, 56, 56, 3)


# ---------------------------------------------------------- held to JAX

@pytest.mark.parametrize("case", list(PAYLOADS))
def test_worker_matches_jax(stack, jax_workers, case):
    """The same payload to each package's worker: the same chunks, bytes
    for bytes (prompt echo, cumulative text, stop cut, error text), and the
    same token ids."""
    kind, payload = PAYLOADS[case]
    want, want_ids = _run(jax_workers[kind], payload)
    got, got_ids = _run(stack.workers[kind], payload)
    assert _masked(got) == _masked(want)
    assert got_ids == want_ids
    codes = [json.loads(c[:-1])["error_code"] for c in got]
    if case.startswith("bad_"):
        assert codes == [1] and got[0].startswith(b'{"text": "server error: ')
    else:
        assert set(codes) == {0} and 0 < len(got_ids) <= payload["max_new_tokens"]


def test_render_prompt_templates_match_jax():
    assert sorted(ttemplates) == sorted(jtemplates)


@pytest.mark.parametrize("template", sorted(jtemplates))
def test_render_prompt_matches_jax(template):
    histories = ([[0, "hi"]], [[0, "describe"], [1, "a cat"], [0, "and then?"]],
                 [[0, ""], [1, "ok"], [0, "next"]])
    for history in histories:
        for num_images in range(3):
            try:
                want = jweb._render_prompt(template, history, num_images)
            except Exception as e:  # noqa: BLE001 — a template that cannot render alone
                with pytest.raises(type(e)):
                    tweb._render_prompt(template, history, num_images)
                continue
            assert tweb._render_prompt(template, history, num_images) == want


def test_render_prompt_unknown_template_falls_back():
    assert tweb._render_prompt("nope", [[0, "hi"]], 1) == \
        jweb._render_prompt("nope", [[0, "hi"]], 1) == \
        tweb._render_prompt("qwen_1_5", [[0, "hi"]], 1)


REGISTRATIONS = [  # (name, models, speed, queue_length)
    ("http://w0", ["m"], 1.0, 0), ("http://w1", ["m", "n"], 2.0, 3),
    ("http://w2", ["m"], 0.5, 1), ("http://w3", ["n"], 1.0, 0)]


def _registered(ctrl):
    for name, models, speed, qlen in REGISTRATIONS:
        ctrl.register_worker(name, True, {"model_names": models, "speed": speed,
                                          "queue_length": qlen})
    return ctrl


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_lottery_matches_jax(seed):
    state = np.random.get_state()
    try:
        np.random.seed(seed)
        jc = _registered(jctrl.Controller("lottery"))
        want = [jc.get_worker_address(m) for m in ["m", "n", "x"] * 40]
    finally:
        np.random.set_state(state)
    tc = _registered(tctrl.Controller("lottery", rng=np.random.RandomState(seed)))
    got = [tc.get_worker_address(m) for m in ["m", "n", "x"] * 40]
    assert got == want
    assert {a for a in got if a} == {"http://w0", "http://w1", "http://w2", "http://w3"}


def test_lottery_without_speed():
    ctrl = tctrl.Controller("lottery", rng=np.random.RandomState(0))
    ctrl.register_worker("http://w", True, {"model_names": ["m"], "speed": 0.0})
    assert ctrl.get_worker_address("m") == ""


def test_shortest_queue_matches_jax():
    jc, tc = _registered(jctrl.Controller()), _registered(tctrl.Controller())
    got, want = [], []
    for step in range(12):
        for ctrl, out in ((jc, want), (tc, got)):
            out.append(ctrl.get_worker_address("m" if step % 3 else "n"))
            if step % 4 == 3:
                ctrl.receive_heart_beat("http://w1", 0)
            out.append({n: w.queue_length for n, w in ctrl.workers.items()})
    assert got == want
    assert tc.list_models() == jc.list_models() == ["m", "n"]


class _OneTick(Exception):
    pass


def test_heartbeat_expiry_matches_jax(monkeypatch):
    """One pass of each expiry loop: a worker that checks its heartbeat and
    sent none for CONTROLLER_HEART_BEAT_EXPIRATION seconds goes; one that
    sent one in time, or does not check, stays."""
    now = 1000.0

    def clock(module):
        sleeps = []

        def sleep(s):
            if sleeps:
                raise _OneTick
            sleeps.append(s)
        monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=sleep,
                                                                  time=lambda: now))
        return sleeps

    kept = {}
    for module, cls in ((jctrl, jctrl.Controller), (tctrl, tctrl.Controller)):
        ctrl = object.__new__(cls)
        ctrl.workers, ctrl.lock = {}, threading.Lock()
        for name, check, last in (("stale", True, now - 31), ("fresh", True, now - 29),
                                  ("unchecked", False, now - 100)):
            ctrl.workers[name] = module.WorkerInfo(["m"], 1.0, 0, check, last)
        sleeps = clock(module)
        with pytest.raises(_OneTick):
            ctrl._expire_loop()
        assert sleeps == [30]
        kept[module.__name__] = sorted(ctrl.workers)
    assert kept[tctrl.__name__] == kept[jctrl.__name__] == ["fresh", "unchecked"]


def test_engine_worker_concurrent_requests(stack, jax_workers):
    """Three requests at once through the controller to the engine worker:
    each stream has JAX's engine worker's chunks for its prompt."""
    prompts = [("<image>\ndescribe", VIDEO), ("hello world", []), ("a cat sits", [])]
    wants = [[json.loads(c[:-1]) for c in _run(jax_workers["engine"], {
        "prompt": p, "images": im, "max_new_tokens": 6})[0]] for p, im in prompts]
    outs = [None] * 3

    def request(i):
        p, im = prompts[i]
        outs[i] = list(client.stream_generate(stack.ctrl, NAMES["engine"], p, images=im,
                                              max_new_tokens=6))
    threads = [threading.Thread(target=request, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert outs == wants


@contextlib.contextmanager
def _lines(*answers):
    """`input` answers each line, then raises EOFError."""
    feed = iter(answers)

    def fake(prompt=""):
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None
    saved = builtins.input
    builtins.input = fake
    try:
        yield
    finally:
        builtins.input = saved


@pytest.mark.parametrize("media", ["text", "video", "image"])
def test_cli_matches_jax(fp32, ckpt_dir, tmp_path, capsys, monkeypatch, media):  # noqa: F811
    """Two turns of each package's `cli.main`: the same printed chat and the
    same token ids each turn."""
    args = []
    if media == "video":
        np.save(tmp_path / "clip.npy",
                np.random.default_rng(4).integers(0, 256, (5, 40, 56, 3), dtype=np.uint8))
        args = ["--video-file", str(tmp_path / "clip.npy")]
    elif media == "image":
        Image.fromarray(np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8)
                        ).save(tmp_path / "img.png")
        args = ["--image-file", str(tmp_path / "img.png")]
    args += ["--model-path", ckpt_dir, "--max-new-tokens", "6"]
    printed, ids = [], []
    for module, model_cls, extra in ((jcli, jmodel.MavlmForCausalLM, []),
                                     (tcli, tmodel.MavlmForCausalLM, ["--device-map", "cpu"])):
        seen = []
        stream = model_cls.generate_stream

        def recorded(self, *a, _stream=stream, _seen=seen, **kw):
            _seen.append([])
            for chunk in _stream(self, *a, **kw):
                _seen[-1].extend(int(t) for t in chunk)
                yield chunk
        monkeypatch.setattr(model_cls, "generate_stream", recorded)
        with _lines("describe it", "and then?"):
            module.main(args + extra)
        printed.append(capsys.readouterr().out)
        ids.append(seen)
    assert printed[1] == printed[0] and printed[0].count("assistant: ") == 2
    assert ids[1] == ids[0] and [len(t) for t in ids[0]] == [6, 6]


# ------------------------------------------------------------ the card

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_workers_need_the_card(fp32, ckpt_dir, no_card):  # noqa: F811
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmw.ModelWorker(None, "local", ckpt_dir, register=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsg.SGLangWorker(None, "local", ckpt_dir, register=False, **ENGINE_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"), _lines("hi"):
        tcli.main(["--model-path", ckpt_dir])


class _Server:
    """Stands in for ThreadingHTTPServer in a `main`: keeps the handler and
    returns from `serve_forever` at once."""

    made = []

    def __init__(self, address, handler):
        self.address, self.handler = address, handler
        _Server.made.append(self)

    def serve_forever(self):
        pass


@pytest.mark.parametrize("entry", ["model_worker", "sglang_worker"])
def test_worker_mains(fp32, ckpt_dir, no_card, monkeypatch, entry):  # noqa: F811
    """The workers' `main`: the card unless `--device-map cpu`; the port
    and the address from the flags."""
    module = {"model_worker": tmw, "sglang_worker": tsg}[entry]
    monkeypatch.setattr(module, "ThreadingHTTPServer", _Server)
    argv = ["--model-path", ckpt_dir, "--port", "0", "--controller-address", "http://nowhere"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    registered = []
    monkeypatch.setattr(tmw.ModelWorker, "register_to_controller",
                        lambda self: registered.append(self))
    monkeypatch.setattr(tmw.ModelWorker, "_heartbeat_loop", lambda self: None)
    _Server.made.clear()
    module.main(argv + ["--device-map", "cpu"])
    (worker,) = registered
    assert _Server.made[0].address == ("0.0.0.0", 0)
    assert worker.worker_addr == "http://localhost:0"
    assert worker.model.device == torch.device("cpu")
    if entry == "sglang_worker":
        assert (worker.engine.num_slots, worker.engine.max_len) == (4, 4096)
        worker.engine.shutdown()


def test_controller_and_web_mains(monkeypatch):
    for module in (tctrl, tweb):
        monkeypatch.setattr(module, "ThreadingHTTPServer", _Server)
    _Server.made.clear()
    tctrl.main(["--port", "0", "--dispatch-method", "lottery"])
    tweb.main(["--port", "0", "--controller-url", "http://c:1"])
    assert [s.address for s in _Server.made] == [("0.0.0.0", 0), ("0.0.0.0", 0)]
