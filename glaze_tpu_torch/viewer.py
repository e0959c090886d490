"""Live-updating browser viewer: MJPEG over HTTP around RealtimeRenderer
(a port of :mod:`glaze_tpu.viewer`).

The reference's core interactive UX is a continuously-refreshing winit
window with mouse-look + WASD camera driving (app/src/viewport.rs:81-247)
and an imgui settings overlay (app/src/ui.rs). On a headless host the
equivalent is a tiny self-hosted web viewer:

* ``GET /``        — a control page: the live image, keyboard bindings
  (w/a/s/d/q/e move, arrows look — viewport.rs:157-205), drag-look,
  render-scale / integrator / exposure controls (ui.rs settings window).
* ``GET /stream``  — ``multipart/x-mixed-replace`` MJPEG: every finished
  progressive launch is pushed as a JPEG part, so the browser shows the
  accumulation refining in place, exactly like the reference's redraw
  loop (viewport.rs:120-155).
* ``GET /frame``   — one JPEG frame (scripting / tests).
* ``POST /control``— JSON camera/settings commands; any edit restarts
  progressive accumulation (RealtimeRenderer semantics).
* ``GET /stats``   — JSON fps / spp counters (ui.rs stats window).
* ``GET /scene``   — JSON materials, lights and textures (the edit panel).
* ``GET /tex/<id>`` — a texture's pixels as PNG.

Rendering and every edit run on ONE background thread; HTTP threads only
queue commands, read the stats and consume the latest encoded frame under
a condition variable. A background scene load decodes on its own worker
thread, and the render thread uploads it. Start with::

    python -m glaze_tpu_torch.viewer scene.glaze [--port 8000] [--scale 0.5]
        [--device cuda|cpu]

(``--port 0`` takes a free port; the default device is ``cuda``, and
without a card it raises.)
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>glaze viewer</title><style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em }
 img { image-rendering:pixelated; border:1px solid #444; max-width:95vw }
 #hud { margin:0.5em 0 }
 button { background:#222; color:#ddd; border:1px solid #555; margin:2px }
</style></head><body>
<div id="hud">
 <b>glaze</b>
 <button onclick="ctl('mode','toggle')">raytrace on/off</button>
 <button onclick="ctl('integrator','pt')">pt</button>
 <button onclick="ctl('integrator','direct')">direct</button>
 <button onclick="ctl('denoise','toggle')">denoise</button>
 <button onclick="ctl('coherent',2)">coherent</button>
 <button onclick="ctl('coherent',0)">indep</button>
 <button onclick="ctl('scale',0.25)">scale .25</button>
 <button onclick="ctl('scale',0.5)">scale .5</button>
 <button onclick="ctl('scale',1.0)">scale 1</button>
 <button onclick="ctl('save')">save</button>
 <button onclick="{const p = prompt('save as path:');
   if (p) ctl('save', p);}">save as</button>
 <button onclick="{const p = prompt('scene path to load:');
   if (p) ctl('load', p);}">load scene</button>
 <span id="stats"></span>
</div>
<img id="view" src="/stream">
<p>keys: w/a/s/d move (shift = fast), q/e up/down, arrows look,
 drag to look</p>
<details><summary>controls</summary>
 sensitivity <input type="number" value="1" step="0.1" __R_SENS__
  onchange="ctl('set',['sensitivity',parseFloat(this.value)])">
 speed <input type="number" value="1" step="0.1" __R_SPEED__
  onchange="ctl('set',['mov_speed',parseFloat(this.value)])">
 fast mult <input type="number" value="2.5" step="0.5" __R_MUL__
  onchange="ctl('set',['mov_speed_mul',parseFloat(this.value)])">
 vert speed <input type="number" value="1" step="0.1" __R_VERT__
  onchange="ctl('set',['vert_speed',parseFloat(this.value)])">
 <label><input type="checkbox"
  onchange="ctl('set',['invert_h',this.checked])">invert h</label>
 <label><input type="checkbox"
  onchange="ctl('set',['invert_v',this.checked])">invert v</label>
 <label><input type="checkbox"
  onchange="ctl('set',['invert_move',this.checked])">invert vert move</label>
</details>
<details id="edit"><summary>materials &amp; lights &amp; textures</summary>
 <div id="mats"></div><div id="lights"></div>
 <select id="newlight"><option>omni</option><option>sun</option>
  <option>area</option><option>sky</option></select>
 <button onclick="addLight()">add light</button>
 <div id="texs"></div>
</details>
<script>
function ctl(action, value, fast) {
  fetch('/control',
        {method:'POST', body:JSON.stringify({action, value, fast})});
}
const KEYS = {w:['advance',1], s:['advance',-1], a:['strafe',-1],
              d:['strafe',1], q:['elevate',-1], e:['elevate',1],
              ArrowLeft:['look',[-5,0]], ArrowRight:['look',[5,0]],
              ArrowUp:['look',[0,-5]], ArrowDown:['look',[0,5]]};
document.addEventListener('keydown', ev => {
  const k = KEYS[ev.key.toLowerCase()] || KEYS[ev.key];
  const t = ev.target.tagName;
  if (k && !['INPUT', 'SELECT', 'TEXTAREA', 'BUTTON'].includes(t)) {
    ctl(k[0], k[1], ev.shiftKey); ev.preventDefault();
  }
});
let drag = null;
const img = document.getElementById('view');
img.addEventListener('mousedown', ev => drag = [ev.clientX, ev.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', ev => {
  if (!drag) return;
  const dx = ev.clientX - drag[0], dy = ev.clientY - drag[1];
  drag = [ev.clientX, ev.clientY];
  ctl('look', [dx * 0.3, dy * 0.3]);
});
setInterval(async () => {
  const r = await fetch('/stats'); const s = await r.json();
  document.getElementById('stats').textContent =
    ` ${s.fps.toFixed(1)} fps  spp ${s.spp}  ${s.mode}` +
    (s.loading ? `  [loading ${s.loading.stage} ` +
                 `${(s.loading.fraction*100).toFixed(0)}%]` : '');
}, 1000);
// live material/light edit panel (the ui.rs materials/lights windows)
const MTYPES = ['flat','lambert','mirror','glass','metal','frosted','uber'];
function sel(opts, cur, onch) {
  const s = document.createElement('select');
  for (const o of opts) {
    const e = document.createElement('option');
    e.textContent = o; e.selected = (o === cur); s.appendChild(e);
  }
  s.onchange = () => onch(s.value);
  return s;
}
function num(v, onch) {
  const i = document.createElement('input');
  i.type = 'number'; i.step = '0.1'; i.value = v;
  i.style.width = '5em';
  i.onchange = () => onch(parseFloat(i.value));
  return i;
}
async function refreshScene() {
  const r = await fetch('/scene'); const sc = await r.json();
  const texNames = sc.textures.map(t => `${t.id}:${t.name}`);
  const mats = document.getElementById('mats'); mats.innerHTML = '';
  for (const m of sc.materials) {
    const row = document.createElement('div');
    row.append(`[${m.id}] ${m.name} `);
    row.append(sel(MTYPES, m.type,
      v => ctl('mat', {id: m.id, field: 'type', value: v})));
    row.append(' ior ');
    row.append(num(m.ior,
      v => ctl('mat', {id: m.id, field: 'ior', value: v})));
    if (m.type === 'metal' || m.type === 'mirror')
      row.append(sel(sc.metals, m.metal,
        v => ctl('mat', {id: m.id, field: 'metal', value: v})));
    row.append(' tex ');
    row.append(sel(texNames, `${m.diffuse}:${sc.textures[m.diffuse].name}`,
      v => ctl('mat', {id: m.id, field: 'diffuse',
                       value: parseInt(v.split(':')[0])})));
    const em = document.createElement('input');
    em.type = 'checkbox'; em.checked = m.emission !== null;
    em.onchange = () => ctl('mat', {id: m.id, field: 'emission',
      value: em.checked ? [255, 255, 255] : null});
    row.append(' emissive '); row.append(em);
    mats.appendChild(row);
  }
  const lights = document.getElementById('lights'); lights.innerHTML = '';
  for (const l of sc.lights) {
    const row = document.createElement('div');
    row.append(`[${l.id}] ${l.name} (${l.type}) intensity `);
    row.append(num(l.intensity,
      v => ctl('light', {id: l.id, field: 'intensity', value: v})));
    const col = document.createElement('input');
    col.type = 'color'; col.value = '#ffffff';
    col.onchange = () => {
      const c = [1, 3, 5].map(i => parseInt(col.value.slice(i, i+2), 16)/255);
      ctl('light', {id: l.id, field: 'color', value: c});
    };
    row.append(' '); row.append(col);
    const del = document.createElement('button');
    del.textContent = 'x';
    del.onclick = () => { ctl('light', {id: l.id, op: 'del'});
                          setTimeout(refreshScene, 300); };
    row.append(' '); row.append(del);
    lights.appendChild(row);
  }
  const texs = document.getElementById('texs'); texs.innerHTML = '';
  const FORMATS = ['Gray', 'RgbaNorm', 'RgbaSrgb'];
  for (const t of sc.textures) {
    const row = document.createElement('div');
    const th = document.createElement('img');   // pixel preview
    th.src = `/tex/${t.id}?s=${Date.now()}`;    // (imgui textures window)
    th.height = 40; th.style.verticalAlign = 'middle';
    row.append(th);
    row.append(` tex[${t.id}] ${t.name} ${t.size[0]}x${t.size[1]} `);
    row.append(sel(FORMATS, t.format,
      v => ctl('tex', {id: t.id, field: 'format', value: v})));
    if (t.id > 0) {
      const del = document.createElement('button');
      del.textContent = 'x';
      del.onclick = () => { ctl('tex', {id: t.id, op: 'del'});
                            setTimeout(refreshScene, 300); };
      row.append(' '); row.append(del);
    }
    texs.appendChild(row);
  }
}
function addLight() {
  ctl('light', {op: 'add', value: document.getElementById('newlight').value});
  setTimeout(refreshScene, 300);
}
document.getElementById('edit').addEventListener('toggle', refreshScene);
</script></body></html>"""

# input bounds come from the shared ranges table (glaze_tpu_torch/ui.py)
# so the page, the server clamp, and the app command loop cannot drift
from glaze_tpu_torch.ui import CONTROL_RANGES as _CR  # noqa: E402


def _minmax(key):
    lo, hi = _CR[key]
    return f'min="{lo:g}" max="{hi:g}"'


_PAGE = (_PAGE
         .replace("__R_SENS__", _minmax("mouse_sensitivity"))
         .replace("__R_SPEED__", _minmax("mov_speed"))
         .replace("__R_MUL__", _minmax("mov_speed_mul"))
         .replace("__R_VERT__", _minmax("vert_speed")))


from glaze_tpu_torch.core import LightType, MaterialType  # noqa: E402

_MTYPES = MaterialType.by_name()
_LTYPES = LightType.by_name()


class ViewerState:
    """Latest-frame mailbox + control queue shared between the render
    thread and HTTP handler threads."""

    def __init__(self, rt):
        self.rt = rt
        self.cond = threading.Condition()
        self.jpeg = None
        self.seq = 0
        self.commands = []
        self.running = True
        self.loader = None  # in-flight BackgroundSceneLoader
        # camera step per keypress: scene-constant, read once per scene
        self.step = self._step()
        # control settings (ui.rs:30-36 + the Controls window, 343-358)
        self.mov_speed = 1.0
        self.mov_speed_mul = 2.5   # shift held
        self.vert_speed = 1.0
        self.sensitivity = 1.0
        self.invert_h = False
        self.invert_v = False
        self.invert_move = False

    # -- render-thread side --------------------------------------------------
    def publish(self, frame: np.ndarray):
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, "JPEG", quality=90)
        with self.cond:
            self.jpeg = buf.getvalue()
            self.seq += 1
            self.cond.notify_all()

    def apply_commands(self):
        with self.cond:
            cmds, self.commands = self.commands, []
        for c in cmds:
            try:
                self._apply(c)
            except Exception as e:  # bad command: keep serving
                print(f"viewer: command {c} failed: {e}")
        # background scene load completion (ui.rs:1101+): the worker
        # thread decoded everything; upload + BVH build happen here on
        # the render thread, then the next frame shows the new scene
        ld = self.loader
        if ld is not None and ld.done:
            self.loader = None
            if ld.error is not None:
                print(f"viewer: scene load failed: {ld.error}")
            else:
                self.rt.change_scene(ld.result)
                self.step = self._step()
                print(f"viewer: loaded {ld.path}")

    def _step(self):
        return float(self.rt._rt.scene.scene_radius.item()) * 0.05

    def _apply(self, c):
        rt = self.rt
        act, val = c.get("action"), c.get("value")
        step = self.step * self.mov_speed
        if c.get("fast"):  # LSHIFT (viewport.rs:176-186)
            step *= self.mov_speed_mul
        if act == "advance":
            rt.advance(step * float(val))
        elif act == "strafe":
            rt.strafe(step * float(val))
        elif act == "elevate":
            # vertical movement has its own speed setting (ui.rs:349)
            v = step / self.mov_speed * self.vert_speed * float(val)
            rt.elevate(-v if self.invert_move else v)
        elif act == "look":
            dx, dy = (float(v) for v in val)
            dx *= self.sensitivity * (-1.0 if self.invert_h else 1.0)
            dy *= self.sensitivity * (-1.0 if self.invert_v else 1.0)
            rt.look_around(dx * np.pi / 180.0, dy * np.pi / 180.0)
        elif act == "set":
            from glaze_tpu_torch.ui import CONTROL_FLAGS, CONTROL_RANGES, clamp

            key, v = val
            key = {"sensitivity": "mouse_sensitivity"}.get(key, key)
            attr = {"mouse_sensitivity": "sensitivity"}.get(key, key)
            if key in CONTROL_RANGES:
                setattr(self, attr, clamp(key, v))
            elif key in CONTROL_FLAGS:
                setattr(self, key, bool(v))
            else:
                raise ValueError(f"unknown setting {key!r}")
        elif act == "scale":
            rt.set_render_scale(float(val))
        elif act == "mode":
            rt.use_raytracer = (not rt.use_raytracer if val == "toggle"
                                else bool(val))
        elif act == "denoise":
            rt.denoise = (not rt.denoise if val == "toggle" else bool(val))
        elif act == "integrator":
            from glaze_tpu_torch.render.renderer import Integrator

            rt._rt.set_integrator(Integrator(str(val).lower()))
        elif act == "coherent":
            # per-renderer coherent switch (0 off / 1 frame / 2 tile;
            # default tile: blotches bounded to one packet tile)
            rt.coherent = int(val)
        elif act == "exposure":
            rt._rt.set_exposure(float(val))
        elif act == "load":
            # background-thread scene load with progress (ui.rs:88-95);
            # frames keep flowing from the old scene while it decodes
            from glaze_tpu_torch.loader import BackgroundSceneLoader

            if self.loader is not None and not self.loader.done:
                raise ValueError("a scene load is already in flight")
            self.loader = BackgroundSceneLoader(str(val))
        elif act == "save":
            # scene save / save-as (ui.rs save buttons, scene.rs:477-511)
            if val:
                rt.save_as(str(val))
            else:
                rt.save()
            print("viewer: scene saved" + (f" as {val}" if val else ""))
        elif act == "mat":
            # live material edit (ui.rs materials window)
            from glaze_tpu_torch.core import Metal

            mid = int(val["id"])
            mat = rt.materials()[mid]
            field, v = val["field"], val["value"]
            if field == "type":
                mat.mtype = _MTYPES[str(v).lower()]
            elif field == "ior":
                mat.ior = float(v)
            elif field == "metal":
                mat.metal = Metal[str(v).upper()]
            elif field == "diffuse":
                tid = int(v)
                if not 0 <= tid < len(rt.textures()):
                    raise ValueError(f"no texture {tid}")
                mat.diffuse = tid
            elif field == "emission":
                # ui.rs emission color edit; null clears (no AREA light)
                mat.emissive_col = (None if v is None
                                    else tuple(int(x) for x in v))
            else:
                raise ValueError(f"unknown material field {field!r}")
            rt.change_material(mid, mat)
        elif act == "tex":
            # textures window (ui.rs: format select / remove; adding
            # files goes through glaze-app's `tex add` on the host)
            from glaze_tpu_torch.core import TextureFormat

            tid = int(val["id"])
            if val.get("op") == "del":
                rt.remove_texture(tid)
            elif val.get("field") == "format":
                rt.set_texture_format(tid, TextureFormat(str(val["value"])))
            else:
                raise ValueError(f"unknown tex op {val!r}")
        elif act == "light":
            # live light edit (ui.rs lights window)
            from glaze_tpu_torch.core import Light, Spectrum

            op = val.get("op", "set")
            if op == "add":
                rt.update_light(len(rt.lights()),
                                Light(ltype=_LTYPES[str(val["value"]).lower()]))
            elif op == "del":
                rt.remove_light(int(val["id"]))
            else:
                lid = int(val["id"])
                light = rt.lights()[lid]
                field, v = val["field"], val["value"]
                if field == "intensity":
                    light.intensity = float(v)
                elif field == "color":
                    light.color = Spectrum.from_rgb(
                        [float(x) for x in v], True)
                else:
                    raise ValueError(f"unknown light field {field!r}")
                rt.update_light(lid, light)
        else:
            raise ValueError(f"unknown action {act!r}")

    # -- HTTP side -----------------------------------------------------------
    def enqueue(self, cmd: dict):
        with self.cond:
            self.commands.append(cmd)

    def wait_frame(self, last_seq, timeout=120.0):
        with self.cond:
            self.cond.wait_for(
                lambda: (self.jpeg is not None and self.seq != last_seq)
                or not self.running,
                timeout=timeout)
            return self.jpeg, self.seq

    def scene_listing(self):
        """Materials/lights inventory for the edit panel (ui.rs
        materials/lights windows). Reads host-side python objects only —
        benign against concurrent edits (single-field dataclass reads)."""
        from glaze_tpu_torch.core import Metal

        rt = self.rt
        return {
            "materials": [
                {"id": i, "name": m.name or f"mat{i}",
                 # "uber": the token the page's type dropdown lists
                 # (display_name "Generic (GGX)" is the combo label)
                 "type": ("uber" if m.mtype == MaterialType.UBER
                          else m.mtype.display_name.lower()),
                 "ior": float(m.ior),
                 "diffuse": int(m.diffuse),
                 "emission": (None if m.emissive_col is None
                              else list(m.emissive_col)),
                 "metal": m.metal.name.lower()}
                for i, m in enumerate(rt.materials())],
            "lights": [
                {"id": i, "name": l.name or f"light{i}",
                 "type": l.ltype.name.lower(),
                 "intensity": float(l.intensity)}
                for i, l in enumerate(rt.lights())],
            "textures": [
                {"id": i, "name": t.info.name or f"tex{i}",
                 "format": t.info.format.value,
                 "size": [int(t.info.width), int(t.info.height)]}
                for i, t in enumerate(rt.textures())],
            "metals": [m.name.lower() for m in Metal],
        }

    def stats(self):
        rt = self.rt
        spp = 0
        try:
            # count is per-lane launches (each advances samples_in_flight
            # samples per pixel), reduced on the device; a read that races
            # an edit on the render thread reports 0
            count = rt._rt._state.count.max().item()
            spp = (int(count) * rt._rt.samples_in_flight
                   // rt._rt.integrator.steps_per_sample)
        except Exception:
            pass
        ld = self.loader
        return {"fps": rt.stats.fps, "spp": spp,
                "mode": (rt._rt.integrator.value if rt.use_raytracer
                         else "preview"),
                "scale": rt.render_scale,
                "loading": (None if ld is None or ld.done
                            else {"stage": ld.stage,
                                  "fraction": ld.fraction})}


def render_loop(state: ViewerState):
    """The progressive redraw loop (viewport.rs:120-155): apply queued
    edits, advance one launch, publish the frame. A crash here must not
    leave HTTP clients blocking on a frame that will never come."""
    try:
        while state.running:
            state.apply_commands()
            frame = state.rt.draw_frame(pipelined=True)
            state.publish(frame)
    except Exception as e:
        print(f"viewer: render loop died: {e!r}")
        raise
    finally:
        with state.cond:
            state.running = False
            state.cond.notify_all()


class _Handler(BaseHTTPRequestHandler):
    state: ViewerState = None  # set by serve()

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        if self.path == "/":
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/frame":
            jpeg, _ = self.state.wait_frame(-1)
            if jpeg is None:
                self.send_error(503, "no frame yet")
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(jpeg)))
            self.end_headers()
            self.wfile.write(jpeg)
        elif self.path == "/stats":
            body = json.dumps(self.state.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/scene":
            body = json.dumps(self.state.scene_listing()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/tex/"):
            # texture pixel preview (the imgui textures window renders
            # texture contents via descriptors, vulkan/imgui.rs:39-628)
            try:
                tid = int(self.path[5:].split("?")[0])
                tex = self.state.rt.textures()[tid]
            except (ValueError, IndexError):
                self.send_error(404, "no such texture")
                return
            import io as _io

            from PIL import Image

            buf = _io.BytesIO()
            Image.fromarray(tex.data[0]).save(buf, "PNG")
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/stream":
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "multipart/x-mixed-replace; boundary=glazeframe")
            self.end_headers()
            seq = -1
            try:
                while self.state.running:
                    jpeg, seq = self.state.wait_frame(seq)
                    if jpeg is None:
                        continue
                    self.wfile.write(b"--glazeframe\r\n")
                    self.wfile.write(b"Content-Type: image/jpeg\r\n")
                    self.wfile.write(
                        f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                    self.wfile.write(jpeg)
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path != "/control":
            self.send_error(404)
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            cmd = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError:
            self.send_error(400, "bad json")
            return
        self.state.enqueue(cmd)
        self.send_response(204)
        self.end_headers()


def serve(rt, host="127.0.0.1", port=8000):
    """Starts the render thread and binds the HTTP server (``port`` 0 takes
    a free port: ``server.server_address[1]``); returns (server, state,
    render_thread). The caller runs ``server.serve_forever``, then shuts
    down: ``state.running = False``, ``server.shutdown()``, and joins the
    render thread."""
    state = ViewerState(rt)
    handler = type("Handler", (_Handler,), {"state": state})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=render_loop, args=(state,), daemon=True)
    t.start()
    return srv, state, t


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="glaze-viewer", description="Live browser viewer (MJPEG)")
    p.add_argument("scene")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--res", default="512x384")
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to render on (default cuda; no fallback)")
    args = p.parse_args(argv)

    from glaze_tpu_torch.converter import ensure_glaze
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.realtime import RealtimeRenderer

    w, h = (int(v) for v in args.res.split("x"))
    rt = RealtimeRenderer(parse(ensure_glaze(args.scene)), width=w, height=h,
                          render_scale=args.scale, device=args.device)
    srv, state, t = serve(rt, host=args.host, port=args.port)
    print(f"glaze viewer on http://{args.host}:{srv.server_address[1]}/",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        with state.cond:
            state.running = False
            state.cond.notify_all()
        srv.shutdown()
        srv.server_close()
        t.join()
    return 0


if __name__ == "__main__":
    main()
