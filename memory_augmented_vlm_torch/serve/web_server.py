"""Web chat UI (counterpart of `memory_augmented_vlm_tpu/serve/web_server.py`;
the reference's `gradio_web_server.py` and `gradio_multi_image.py`,
llava/serve/) on the standard library's http.server:

  - a model selector fed from the controller's registry;
  - a conversation-template selector (every registered template); the
    prompt is rendered on the server through the template objects;
  - multi-turn history with regenerate and clear;
  - several images a message, each an `<image>` slot, with thumbnails;
  - temperature, top-p and max-new-tokens controls;
  - streamed answers: newline-delimited JSON over chunked HTTP, relaying
    the worker's `\\0`-delimited stream with the prompt echo stripped.

    python -m memory_augmented_vlm_torch.serve.web_server [--port 7860]
        [--controller-url http://localhost:10000]

The topology is the reference's: UI -> controller (/get_worker_address) ->
worker (/worker_generate_stream).
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.conversation import conv_templates

_PAGE = """<!doctype html>
<html><head><title>mavlm_torch chat</title><style>
body{font-family:system-ui,sans-serif;max-width:900px;margin:1.5em auto;padding:0 1em}
#log{border:1px solid #ccc;border-radius:8px;padding:1em;min-height:320px;white-space:pre-wrap}
.turn{margin:.4em 0;padding:.5em .8em;border-radius:8px}
.u{background:#eef4ff}.a{background:#eefbf0}
.role{font-weight:600;font-size:.85em;color:#555}
textarea{width:100%%;box-sizing:border-box}
button{padding:.45em 1.4em;margin-right:.5em}
#thumbs img{height:54px;margin:2px;border-radius:4px;border:1px solid #ddd}
.controls{display:flex;gap:1.2em;flex-wrap:wrap;align-items:center;margin:.6em 0}
.controls label{font-size:.85em;color:#444}
</style></head><body>
<h2>mavlm_torch chat</h2>
<div class=controls>
  <label>model <select id=model></select></label>
  <label>template <select id=template></select></label>
  <label>temperature <input type=range id=temp min=0 max=1 step=0.05 value=0
    oninput="tv.textContent=this.value"> <span id=tv>0</span></label>
  <label>top-p <input type=range id=topp min=0.05 max=1 step=0.05 value=0.7
    oninput="pv.textContent=this.value"> <span id=pv>0.7</span></label>
  <label>max tokens <input type=number id=maxtok value=256 min=1 max=2048
    style="width:5em"></label>
</div>
<div id=log></div>
<div class=controls>
  <input type=file id=media accept="image/*" multiple>
  <span id=thumbs></span>
</div>
<textarea id=msg rows=3 placeholder="message (attach images above; each becomes an <image> slot)"></textarea>
<div class=controls>
  <button onclick=send()>send</button>
  <button onclick=regenerate()>regenerate</button>
  <button onclick=clearChat()>clear</button>
</div>
<script>
let history = [];      // [{role: 0|1, text, images: [b64...]}]
let pendingImages = [];

async function post(path, body){
  const r = await fetch(path, {method:'POST', body: JSON.stringify(body)});
  return r.json();
}
async function init(){
  const m = await post('/proxy/list_models', {});
  for(const name of (m.models||[])) model.add(new Option(name, name));
  const t = await post('/templates', {});
  for(const name of t.templates)
    template.add(new Option(name, name, name==t.default_name, name==t.default_name));
}
document.getElementById('media').onchange = async (e) => {
  pendingImages = []; thumbs.innerHTML = '';
  for(const f of e.target.files){
    const buf = new Uint8Array(await f.arrayBuffer());
    let s = ''; for(const b of buf) s += String.fromCharCode(b);
    const b64 = btoa(s);
    pendingImages.push(b64);
    thumbs.innerHTML += '<img src="data:image/*;base64,'+b64+'">';
  }
};
function esc(s){
  // user/model text goes through innerHTML — escape markup (XSS + literal
  // '<image>' tokens in outputs)
  return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
                  .replace(/>/g,'&gt;').replace(/"/g,'&quot;');
}
function render(){
  log.innerHTML = '';
  for(const t of history){
    const cls = t.role ? 'a' : 'u';
    const who = t.role ? 'assistant' : 'user';
    const imgs = (t.images||[]).map(
      b=>'<img src="data:image/*;base64,'+b+'" style="height:54px">').join('');
    log.innerHTML += '<div class="turn '+cls+'"><div class=role>'+who+
                     '</div>'+imgs+'<div>'+esc(t.text)+'</div></div>';
  }
  log.scrollTop = log.scrollHeight;
}
async function run(){
  history.push({role:1, text:''});
  render();
  const body = {
    model: model.value, template: template.value,
    history: history.slice(0,-1).map(t=>[t.role, t.text]),
    images: history.flatMap(t=>t.images||[]),
    temperature: parseFloat(temp.value), top_p: parseFloat(topp.value),
    max_new_tokens: parseInt(maxtok.value),
  };
  const resp = await fetch('/chat', {method:'POST', body: JSON.stringify(body)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while(true){
    const {done, value} = await reader.read();
    if(done) break;
    buf += dec.decode(value, {stream:true});
    const lines = buf.split('\\n'); buf = lines.pop();
    for(const ln of lines){
      if(!ln.trim()) continue;
      const out = JSON.parse(ln);
      history[history.length-1].text = out.error_code ?
        '[error] '+out.text : out.text;
      render();
    }
  }
}
async function send(){
  const text = msg.value.trim();
  if(!text && !pendingImages.length) return;
  history.push({role:0, text: text, images: pendingImages});
  pendingImages = []; thumbs.innerHTML = ''; media.value = ''; msg.value='';
  await run();
}
async function regenerate(){
  while(history.length && history[history.length-1].role) history.pop();
  if(history.length) await run();
}
function clearChat(){ history = []; render(); }
init();
</script></body></html>"""


def _render_prompt(template_name: str, history, num_images: int) -> str:
    """Build the LM prompt server-side through the real conversation
    templates (the gradio server does the same with conv.get_prompt())."""
    conv = conv_templates.get(template_name, conv_templates["qwen_1_5"]).copy()
    image_tokens = (constants.DEFAULT_IMAGE_TOKEN + "\n") * num_images
    first_user = True
    for role_idx, text in history:
        if role_idx == 0 and first_user and num_images:
            text = image_tokens + text
            first_user = False
        conv.append_message(conv.roles[role_idx], text or None)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def make_handler(controller_addr: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = self.rfile.read(n)
            if self.path == "/templates":
                self._json({"templates": sorted(conv_templates),
                            "default_name": "qwen_1_5"})
                return
            if self.path.startswith("/proxy/"):
                req = urllib.request.Request(
                    controller_addr + self.path[len("/proxy"):],
                    data=payload, headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as resp:
                    data = resp.read()
                if b"\0" in data:
                    data = [p for p in data.split(b"\0") if p][-1]
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(data)
                return
            if self.path == "/chat":
                self._chat(json.loads(payload or b"{}"))
                return
            self.send_response(404)
            self.end_headers()

        def _chat(self, params: dict):
            history = params.get("history") or []
            images = params.get("images") or []
            prompt = _render_prompt(params.get("template", "qwen_1_5"),
                                    history, len(images))
            addr_req = urllib.request.Request(
                controller_addr + "/get_worker_address",
                data=json.dumps({"model": params.get("model", "")}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(addr_req, timeout=10) as resp:
                worker = json.loads(resp.read()).get("address", "")
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            if not worker:
                self.wfile.write(json.dumps(
                    {"text": "no worker for model", "error_code": 2}).encode()
                    + b"\n")
                return
            gen_req = urllib.request.Request(
                worker + "/worker_generate_stream",
                data=json.dumps({
                    "prompt": prompt,
                    "images": images,
                    "temperature": params.get("temperature", 0.0),
                    "top_p": params.get("top_p"),
                    "max_new_tokens": params.get("max_new_tokens", 256),
                    "stop": params.get("stop"),
                }).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(gen_req, timeout=600) as resp:
                buf = b""
                while True:
                    chunk = resp.read(4096)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\0" in buf:
                        piece, buf = buf.split(b"\0", 1)
                        if not piece:
                            continue
                        out = json.loads(piece)
                        # strip the echoed prompt for display
                        text = out.get("text", "")
                        if text.startswith(prompt):
                            text = text[len(prompt):]
                        self.wfile.write(json.dumps(
                            {"text": text,
                             "error_code": out.get("error_code", 0)}).encode()
                            + b"\n")
                        self.wfile.flush()

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--controller-url", default="http://localhost:10000")
    args = p.parse_args(argv)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(args.controller_url))
    print(f"web UI at http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
