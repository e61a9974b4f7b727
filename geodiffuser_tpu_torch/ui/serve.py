"""The web UI on the standard library's HTTP server.

Counterpart of `geodiffuser_tpu/ui/serve.py`: the reference's two Gradio
tabs (geo_diff_ui.py:62-1272), "Editing Real Image" and "Inpainting" with
the advanced accordion (geo_diff_ui.py:291-527), as one HTML page talking
JSON to handlers over `ui/callbacks.py`.  Images travel as base64 PNG,
encoded and decoded by the port's own codec (`utils/png.py`); the server
reads PNG only, and the page converts any upload to PNG in the browser
(it draws the file on a canvas and sends `toDataURL('image/png')`).

Endpoints:
  GET  /                  the app page
  GET  /api/state         which inputs are loaded, a running edit's progress
  POST /api/load_image    {image}                   -> {image}
  POST /api/click         {x, y}  (fractions)       -> {mask}   (SAM)
  POST /api/set_mask      {mask}                    -> {mask}   (no SAM)
  POST /api/depth         {model, translate_factor} -> {depth}
  POST /api/preview       {tx..sz, focal}           -> {preview}
  POST /api/edit          {prompt, advanced{}}      -> {edited}
  POST /api/inpaint       {prompt, advanced{}}      -> {edited}
  POST /api/save          {root, category}          -> {folder}
  POST /api/load          {folder}                  -> {image, mask, depth}
(an edit's per-step loss shows in /api/state's progress.desc).

`ThreadingHTTPServer` serves each request in a thread of its own.  One
edit runs at a time (`UIApp._edit_lock`); a depth or SAM request may run
beside it (the predictors enter `torch.inference_mode()` in their own
thread, grad mode being per thread, and every call names its device).

    python -m geodiffuser_tpu_torch.ui --native [--port 7860]
        [--checkpoint-dir DIR] [--device cuda] [--tiny]
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.ui import callbacks as cb
from geodiffuser_tpu_torch.utils import png

log = logging.getLogger(__name__)


class BadRequest(ValueError):
    """A request the server refuses (answered with status 400)."""


# ----------------------------------------------------------------- image codec
def _png_b64(arr: np.ndarray) -> str:
    """uint8 (H, W) gray or (H, W, 3), or float in [0, 1] or [0, 255] -> base64 PNG."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0.0, 1.0) if arr.max() <= 1.5 else arr / 255.0
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(png.encode_png(arr)).decode("ascii")


def _b64_png(data: str) -> np.ndarray:
    """base64 PNG (or a data: URL of one) -> (H, W, 3) uint8."""
    try:
        raw = base64.b64decode(data.split(",")[-1], validate=True)
    except (binascii.Error, ValueError) as exc:
        raise BadRequest(f"images must be base64 PNG data ({exc})") from exc
    try:
        return png.to_rgb(png.decode_png(raw, "upload"))
    except ValueError as exc:
        raise BadRequest(f"images must be 8-bit PNG files; the page converts other "
                         f"formats to PNG before sending ({exc})") from exc


def _gray_view(depth: np.ndarray) -> np.ndarray:
    d = np.asarray(depth, np.float32)
    lo, hi = float(d.min()), float(d.max())
    return ((d - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)


# ------------------------------------------------------------------- app logic
class UIApp:
    """One UIState and the edit bookkeeping behind the HTTP handlers; one
    user a process, as the reference app keeps one shared state
    (editor.py:52-56)."""

    def __init__(self, pipeline, sam_predictor=None, depth_predictor=None, device="cuda"):
        dev = resolve_device(device)
        if dev != pipeline.device:
            raise ValueError(f"UI device {dev} differs from the pipeline's {pipeline.device}")
        self.state = cb.UIState(pipeline=pipeline, sam_predictor=sam_predictor,
                                depth_predictor=depth_predictor, device=str(dev))
        self.progress = {"frac": 0.0, "desc": "", "running": False}
        self._edit_lock = threading.Lock()

    # each handler returns a JSON-serializable dict
    def api_state(self, _=None):
        s = self.state
        return {
            "image": s.image is not None, "mask": s.mask is not None,
            "depth": s.depth is not None, "progress": dict(self.progress),
            "depth_models": list(cb.DEPTH_MODELS),
            "categories": list(cb.CATEGORIES),
        }

    def api_load_image(self, req):
        img = cb.load_image(self.state, _b64_png(req["image"]),
                            size=self.state.pipeline.image_size)
        return {"image": _png_b64(img)}

    def api_click(self, req):
        mask = cb.get_mask(self.state, float(req["x"]), float(req["y"]))
        return {"mask": _png_b64(np.asarray(mask) * 255.0)}

    def api_set_mask(self, req):
        m = _b64_png(req["mask"])[..., 0]
        if self.state.image is not None and m.shape != self.state.image.shape[:2]:
            m = png.resize_nearest(m, *self.state.image.shape[:2])
        mask = cb.set_mask(self.state, m.astype(np.float32) / 255.0)
        return {"mask": _png_b64(np.asarray(mask) * 255.0)}

    def api_depth(self, req):
        scaled = cb.get_depth(self.state, req.get("model", "constant"),
                              float(req.get("translate_factor", 0.7)))
        return {"depth": _png_b64(_gray_view(scaled))}

    def api_preview(self, req):
        g = lambda k, d: float(req.get(k, d))
        cb.compose_transform_from_sliders(
            self.state, g("tx", 0), g("ty", 0), g("tz", 0),
            g("rx", 0), g("ry", 0), g("rz", 0), g("sx", 1), g("sy", 1), g("sz", 1))
        prev = cb.get_transformed_preview(self.state, focal_length=g("focal", 550.0))
        return {"preview": _png_b64(prev)}

    def _advanced(self, req) -> cb.AdvancedOptions:
        fields = {f.name for f in dataclasses.fields(cb.AdvancedOptions)}
        adv = {k: v for k, v in (req.get("advanced") or {}).items() if k in fields}
        return cb.AdvancedOptions(**adv)

    def _run_edit(self, fn, req):
        if not self._edit_lock.acquire(blocking=False):
            return {"error": "an edit is already running"}
        try:
            self.progress.update(frac=0.0, desc="starting", running=True)

            def progress(frac, desc=""):
                self.progress.update(frac=float(frac), desc=str(desc))

            out = fn(self.state, req.get("prompt", ""), adv=self._advanced(req),
                     progress=progress)
            return {"edited": _png_b64(out)}
        finally:
            self.progress.update(running=False, frac=1.0, desc="done")
            self._edit_lock.release()

    def api_edit(self, req):
        return self._run_edit(cb.get_edited_image, req)

    def api_inpaint(self, req):
        return self._run_edit(cb.inpaint_mask, req)

    def api_save(self, req):
        folder = cb.save_experiment(self.state, req.get("root", "./ui_outputs"),
                                    req.get("category", "Mix"))
        return {"folder": folder}

    def api_load(self, req):
        cb.load_experiment(self.state, req["folder"])
        s = self.state
        return {
            "image": _png_b64(s.image),
            "mask": _png_b64(np.asarray(s.mask) * 255.0) if s.mask is not None else None,
            "depth": _png_b64(_gray_view(s.depth)) if s.depth is not None else None,
        }


# --------------------------------------------------------------------- server
class _Handler(BaseHTTPRequestHandler):
    app: UIApp = None  # set by make_server

    def log_message(self, fmt, *args):  # through logging, not stderr
        log.debug("ui-http: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/state":
            self._send_json(self.app.api_state())
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self):
        name = self.path.rsplit("/", 1)[-1]
        fn = getattr(self.app, "api_" + name, None)
        if self.path != f"/api/{name}" or fn is None:
            self._send_json({"error": "not found"}, 404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) if n else b"{}")
            self._send_json(fn(req))
        except BadRequest as exc:
            self._send_json({"error": str(exc)}, 400)
        except Exception as exc:  # reported to the page, with the traceback in the log
            log.exception("ui-http %s failed", self.path)
            self._send_json({"error": f"{type(exc).__name__}: {exc}"}, 500)


def make_server(pipeline, host="127.0.0.1", port=7860, sam_predictor=None,
                depth_predictor=None, device="cuda") -> ThreadingHTTPServer:
    """Build (not start) the server of the UI over `pipeline`, which must
    live on `device`; `.serve_forever()` runs it."""
    app = UIApp(pipeline, sam_predictor=sam_predictor, depth_predictor=depth_predictor,
                device=device)
    handler = type("Handler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import argparse

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="a diffusers-layout SD checkpoint (random weights without one)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny random model at 128^2 (a demo; no weights needed)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mcfg = ModelConfig.tiny() if args.tiny else ModelConfig()
    size = 128 if args.tiny and args.image_size == 512 else args.image_size
    pipeline = Pipeline.create(mcfg, image_size=size, checkpoint_dir=args.checkpoint_dir,
                               device=device)
    srv = make_server(pipeline, host=args.host, port=args.port, device=device)
    print(f"GeoDiffuser UI at http://{args.host}:{srv.server_address[1]}/", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


# ----------------------------------------------------------------------- page
# The JAX package's page (two tabs and the advanced accordion, mirroring
# geo_diff_ui.py:62-1272), except that an upload is converted to PNG here.
PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>GeoDiffuser-TPU</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1rem;background:#fafafa;color:#222}
 h1{font-size:1.2rem} .tabs button{padding:.4rem 1rem;margin-right:.3rem;border:1px solid #bbb;
   background:#eee;cursor:pointer;border-radius:4px 4px 0 0}
 .tabs button.on{background:#fff;border-bottom:1px solid #fff;font-weight:600}
 .tab{border:1px solid #bbb;padding:1rem;background:#fff;display:none} .tab.on{display:block}
 .row{display:flex;gap:1rem;flex-wrap:wrap;margin-bottom:.8rem}
 .cell{display:flex;flex-direction:column;font-size:.8rem}
 canvas,img.view{width:256px;height:256px;border:1px solid #ccc;image-rendering:pixelated;background:#f0f0f0}
 details{margin:.6rem 0;border:1px solid #ddd;border-radius:4px;padding:.4rem}
 summary{cursor:pointer;font-weight:600}
 label{font-size:.75rem;display:flex;justify-content:space-between;gap:.5rem;width:15rem}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(16rem,1fr));gap:.2rem .8rem}
 button.act{padding:.45rem 1.1rem;font-weight:600;cursor:pointer}
 #status{font-size:.8rem;color:#555;min-height:1.2em;margin:.4rem 0}
 progress{width:16rem;vertical-align:middle}
</style></head><body>
<h1>GeoDiffuser-TPU — geometry-based image editing</h1>
<div class="tabs">
 <button id="tb0" class="on" onclick="tab(0)">Editing Real Image</button>
 <button id="tb1" onclick="tab(1)">Inpainting</button>
</div>

<div id="tab0" class="tab on">
 <div class="row">
  <div class="cell">Input (click object for mask)<canvas id="inp" width=256 height=256></canvas>
    <input type="file" id="file" accept="image/*"></div>
  <div class="cell">Mask<img class="view" id="mask"></div>
  <div class="cell">Depth<img class="view" id="depth"></div>
  <div class="cell">Transformed preview<img class="view" id="prev"></div>
  <div class="cell">Edited<img class="view" id="out"></div>
 </div>
 <div class="row">
  <label>depth model <select id="dmodel"></select></label>
  <label>translate factor <input type="range" id="tfac" min="0" max="2" step="0.05" value="0.7">
    <span id="tfacv">0.7</span></label>
  <button class="act" onclick="getDepth()">Get Depth</button>
 </div>
 <div class="row grid" id="sliders"></div>
 <div class="row">
  <button class="act" onclick="preview()">Check Transformed Image</button>
  <label style="width:24rem">prompt <input id="prompt" style="flex:1"></label>
  <button class="act" onclick="edit()">Move Object</button>
 </div>
 <details><summary>Generation Parameters / Movement Loss Control</summary>
  <div class="grid" id="adv"></div></details>
 <div class="row">
  <label>experiment root <input id="exproot" value="./ui_outputs"></label>
  <label>category <select id="expcat"></select></label>
  <button class="act" onclick="saveExp()">Save Experiment</button>
  <label>folder <input id="loadpath"></label>
  <button class="act" onclick="loadExp()">Load Experiment</button>
  <span id="savedto"></span>
 </div>
</div>

<div id="tab1" class="tab">
 <div class="row">
  <div class="cell">Input (click object)<canvas id="inp2" width=256 height=256></canvas>
   <input type="file" id="file2" accept="image/*"></div>
  <div class="cell">Mask<img class="view" id="mask2"></div>
  <div class="cell">Inpainted<img class="view" id="out2"></div>
 </div>
 <div class="row">
  <label style="width:24rem">prompt <input id="prompt2" style="flex:1"></label>
  <button class="act" onclick="inpaint()">Inpaint Mask</button>
 </div>
</div>
<div id="status"></div><progress id="prog" max="1" value="0" hidden></progress>

<script>
const $=id=>document.getElementById(id);
function tab(i){for(const k of [0,1]){$('tab'+k).classList.toggle('on',k==i);
  $('tb'+k).classList.toggle('on',k==i);}}
async function api(name,body){
  $('status').textContent=name+'…';
  const r=await fetch('/api/'+name,{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify(body||{})});
  const j=await r.json();
  $('status').textContent=j.error?('ERROR '+name+': '+j.error):(name+' ok');
  if(j.error)throw new Error(j.error);
  return j;}
function show(id,b64){if(b64)$(id).src='data:image/png;base64,'+b64;}
function drawOn(cv,b64){const img=new Image();
  img.onload=()=>cv.getContext('2d').drawImage(img,0,0,cv.width,cv.height);
  img.src='data:image/png;base64,'+b64;}
// transform sliders (geo_diff_ui slider ranges)
const TR=[['tx',-0.5,0.5,0,0.01],['ty',-0.5,0.5,0,0.01],['tz',-0.5,0.5,0,0.01],
 ['rx',-90,90,0,1],['ry',-90,90,0,1],['rz',-90,90,0,1],
 ['sx',0.5,1.5,1,0.01],['sy',0.5,1.5,1,0.01],['sz',0.5,1.5,1,0.01],
 ['focal',100,1000,550,1]];
// advanced accordion (ui/app.py:_advanced_accordion; geo_diff_ui.py:291-527)
const ADV=[['guidance_scale',0,10,3,0.1],['cross_replace_steps',0,1,0.97,0.01],
 ['self_replace_steps',0,1,0.97,0.01],['skip_steps',0,10,2,1],
 ['latent_replace',0,1,0.1,0.01],['optimize_steps',0,1,0.65,0.01],
 ['fast_optim_steps',0,1,0,0.01],['num_first_optim_steps',1,50,1,1],
 ['num_ddim_steps',25,50,50,1],['lr',0.001,10,0.03,0.001],
 ['splatting_radius',0,5,1.3,0.01],['splatting_tau',0.001,2,1,0.001],
 ['splatting_points_per_pixel',1,30,15,1],['cam_focal_length',0,3000,550,0.1],
 ['diffusion_correction',0,0.4,0.1,0.01],['removal_loss_adaptive_value',-30,0,-1.5,0.01],
 ['sim_loss_self',0,1000,55,0.01],['sim_loss_cross',0,1000,45,0.01],
 ['movement_loss_self',0,1000,30.5,0.01],['movement_loss_cross',0,1000,30.34,0.01],
 ['removal_loss_self',0,1000,2.6,0.01],['removal_loss_cross',0,1000,2.6,0.01],
 ['amodal_loss_self',0,1000,80.5,0.01],['amodal_loss_cross',0,1000,3.5,0.01],
 ['smoothness_loss_self',0,1000,30,0.01],['smoothness_loss_cross',0,1000,15,0.01]];
function mkSliders(list,el,prefix){for(const[n,lo,hi,v,st]of list){
  const lab=document.createElement('label');
  lab.innerHTML=n+' <input type="range" id="'+prefix+n+'" min="'+lo+'" max="'+hi+
   '" step="'+st+'" value="'+v+'"><span id="'+prefix+n+'v">'+v+'</span>';
  el.appendChild(lab);
  lab.querySelector('input').oninput=e=>$(prefix+n+'v').textContent=e.target.value;}}
mkSliders(TR,$('sliders'),'t_');mkSliders(ADV,$('adv'),'a_');
function vals(list,prefix){const o={};for(const[n]of list)o[n]=parseFloat($(prefix+n).value);return o;}
async function init(){const r=await fetch('/api/state');const s=await r.json();
  for(const m of s.depth_models){const o=document.createElement('option');o.textContent=m;
    if(m=='constant')o.selected=true;$('dmodel').appendChild(o);}
  for(const c of s.categories){const o=document.createElement('option');o.textContent=c;
    if(c=='Mix')o.selected=true;$('expcat').appendChild(o);}}
init();
$('tfac').oninput=e=>$('tfacv').textContent=e.target.value;
for(const[fid,cid]of[['file','inp'],['file2','inp2']])
 $(fid).onchange=async e=>{const f=e.target.files[0];if(!f)return;
  // the server reads PNG only: decode any format here, send the canvas as PNG
  const bmp=await createImageBitmap(f);const cv=document.createElement('canvas');
  cv.width=bmp.width;cv.height=bmp.height;cv.getContext('2d').drawImage(bmp,0,0);
  const j=await api('load_image',{image:cv.toDataURL('image/png')});drawOn($(cid),j.image);drawOn($(cid=='inp'?'inp2':'inp'),j.image);};
for(const[cid,mid]of[['inp','mask'],['inp2','mask2']])
 $(cid).onclick=async e=>{const r=$(cid).getBoundingClientRect();
  const j=await api('click',{x:(e.clientX-r.left)/r.width,y:(e.clientY-r.top)/r.height});
  show('mask',j.mask);show('mask2',j.mask);};
async function getDepth(){const j=await api('depth',{model:$('dmodel').value,
  translate_factor:parseFloat($('tfac').value)});show('depth',j.depth);}
async function preview(){const j=await api('preview',vals(TR,'t_'));show('prev',j.preview);}
function poll(){const t=setInterval(async()=>{const s=await(await fetch('/api/state')).json();
  $('prog').hidden=!s.progress.running;$('prog').value=s.progress.frac;
  if(s.progress.running)$('status').textContent=s.progress.desc;
  if(!s.progress.running)clearInterval(t);},500);}
async function edit(){poll();const j=await api('edit',{prompt:$('prompt').value,
  advanced:vals(ADV,'a_')});show('out',j.edited);}
async function inpaint(){poll();const j=await api('inpaint',{prompt:$('prompt2').value,
  advanced:vals(ADV,'a_')});show('out2',j.edited);}
async function saveExp(){const j=await api('save',{root:$('exproot').value,
  category:$('expcat').value});$('savedto').textContent='saved: '+j.folder;}
async function loadExp(){const j=await api('load',{folder:$('loadpath').value});
  drawOn($('inp'),j.image);drawOn($('inp2'),j.image);show('mask',j.mask);show('depth',j.depth);}
</script></body></html>
"""


if __name__ == "__main__":
    main()
