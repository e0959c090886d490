"""glaze-app on PyTorch/CUDA: interactive scene viewer and editor (a port
of :mod:`glaze_tpu.app`, itself of the reference's app/src/*).

The reference is a winit+imgui window (viewport.rs, ui.rs); on a headless
host the same capabilities are an interactive command loop with a
live-updating PNG (and an optional ANSI terminal preview): WASD/QE camera
movement and mouse-look (viewport.rs:157-247), the materials, lights and
textures editors, render scale, integrator and coherent mode, stats and
scene save/save-as (ui.rs:20-1140). The accumulation keeps refining
between commands, as the reference's redraw loop does.

The scene is a ``.glaze`` or any file the converter imports
(:func:`glaze_tpu_torch.converter.ensure_glaze`). It renders on ``cuda``
unless ``--device cpu`` is given; without a card the default raises.
``--script FILE`` runs the commands of a file, then quits.

Usage: ``python -m glaze_tpu_torch.app scene.glaze [--out view.png]
[--res 512x384] [--scale 1.0] [--terminal] [--script file]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile


HELP = """commands:
  w/a/s/d/q/e [mag] [fast]   move camera (advance/strafe/elevate);
                      "fast" applies the fast-movement multiplier
  look <dx> <dy>      rotate view (degrees)
  drag <dx> <dy> [n]  mouse-look: rotate + draw, n frames (default 8)
  settings            show control settings (ui.rs Controls window)
  set speed|fastmul|vspeed|sensitivity <v>
  set invert_h|invert_v|invert_move on|off
  frames <n>          advance n progressive launches (default 8)
  mat                 list materials
  mat <id> type <t>   set material type (flat|lambert|mirror|glass|metal|frosted|uber)
  mat <id> ior <v>    set dielectric ior
  mat <id> metal <m>  set metal (e.g. GOLD, SILVER, COPPER)
  mat <id> diffuse <r> <g> <b>   set diffuse multiplier (0-255)
  mat <id> tex <slot> <tid>      assign texture (slot: diffuse|roughness|
                                 metalness|opacity|normal; 0 clears)
  tex                 list textures
  tex add <path> [srgb|norm|gray]   load an image as a new texture
  tex del <id>        remove an unused texture
  tex format <id> <srgb|norm|gray>  reinterpret pixel format
  tex show <id> [path]  write a texture's pixels as PNG (the imgui
                      textures-window preview; default glaze_tex_<id>.png
                      in the temporary directory)
  light               list lights
  light <id> intensity <v>
  light <id> color <r> <g> <b>   (0-1 rgb, converted to spectrum)
  light <id> pos <x> <y> <z>
  light add omni|sun|area|sky
  light del <id>
  raytrace on|off     toggle path tracer vs flat raster preview
  denoise on|off      edge-aware display filter on the raytraced preview
  integrator pt|direct   raytracer integrator (raytracer.rs:196-231)
  coherent off|frame|tile   shared-RNG sampling (default tile; faster
                      traces, spatially-correlated noise while converging)
  scale <v>           render scale (renderer.rs:283-315)
  exposure <v>        output exposure multiplier
  stats               fps / progressive sample count
  info                device info (ui.rs info window / DeviceInfo)
  load <path>         open another scene on a background thread with
                      progress, frames keep flowing (ui.rs:88-95)
  save                in-place scene update (ParsedScene::update)
  saveas <path>
  shot <path>         write current frame as PNG
  help                this text
  quit
"""


def _terminal_preview(img, cols=64):
    """Coarse ANSI block preview of the frame."""
    import numpy as np

    h, w = img.shape[:2]
    rows = max(1, int(cols * h / w / 2))
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    out = []
    for y in ys:
        line = []
        for x in xs:
            r, g, b = img[y, x][:3]
            line.append(f"\x1b[48;2;{r};{g};{b}m ")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="glaze-app",
                                description="Interactive glaze scene viewer")
    p.add_argument("scene")
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(),
                                        "glaze_view.png"),
                   help="live view PNG path")
    p.add_argument("--res", default="512x384")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--terminal", action="store_true",
                   help="print an ANSI preview after each command")
    p.add_argument("--script", default=None,
                   help="file with commands to run non-interactively")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to render on (default cuda; no fallback)")
    args = p.parse_args(argv)

    from PIL import Image

    from glaze_tpu_torch.converter import ensure_glaze
    from glaze_tpu_torch.core import Light, LightType, MaterialType, Metal, Spectrum
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.realtime import RealtimeRenderer
    from glaze_tpu_torch.utils import init_logging

    init_logging()
    w, h = (int(v) for v in args.res.lower().split("x"))
    parsed = parse(ensure_glaze(args.scene))
    rr = RealtimeRenderer(parsed, width=w, height=h, render_scale=args.scale,
                          device=args.device)
    print(f"loaded {args.scene}: {len(rr.materials())} materials, "
          f"{len(rr.lights())} lights", file=sys.stderr)

    def present(n=8):
        # pipelined launches (frames-in-flight); the final image read
        # reflects every launch issued
        for _ in range(max(1, n)):
            rr.draw_frame(pipelined=True)
        img = rr.get_image()
        Image.fromarray(img).save(args.out)
        if args.terminal:
            print(_terminal_preview(img))
        print(f"[{rr.stats.fps:.1f} fps] view -> {args.out}", file=sys.stderr)

    present(1)

    if args.script:
        lines = open(args.script).read().splitlines()
        source = iter(lines)
        def read():
            try:
                line = next(source)
                print(f"> {line}", file=sys.stderr)
                return line
            except StopIteration:
                return "quit"
    else:
        def read():
            try:
                return input("glaze> ")
            except EOFError:
                return "quit"

    mtypes = MaterialType.by_name()
    ltypes = LightType.by_name()

    # control settings (ui.rs:30-36 UiState + the Controls window,
    # ui.rs:343-358). Multipliers default to 1.0 — the command loop takes
    # explicit magnitudes where the reference scales raw input deltas —
    # but the knobs and their slider ranges match.
    from glaze_tpu_torch.ui import clamp as ui_clamp

    ui = {"mouse_sensitivity": 1.0, "mov_speed": 1.0, "mov_speed_mul": 2.5,
          "vert_speed": 1.0, "invert_h": False, "invert_v": False,
          "invert_move": False}
    _set_keys = {"speed": "mov_speed", "fastmul": "mov_speed_mul",
                 "vspeed": "vert_speed", "sensitivity": "mouse_sensitivity"}
    _alias = {v: k for k, v in _set_keys.items()}

    def look_deltas(dx_deg, dy_deg):
        s = ui["mouse_sensitivity"]
        dx = math.radians(dx_deg) * s * (-1.0 if ui["invert_h"] else 1.0)
        dy = math.radians(dy_deg) * s * (-1.0 if ui["invert_v"] else 1.0)
        return dx, dy

    while True:
        try:
            line = read().strip()
        except KeyboardInterrupt:
            break
        if not line:
            present()
            continue
        parts = line.split()
        cmd = parts[0].lower()
        try:
            if cmd in ("quit", "exit"):
                break
            elif cmd == "help":
                print(HELP)
            elif cmd in ("w", "a", "s", "d", "q", "e"):
                opts = parts[1:]
                fast = "fast" in opts
                nums = [p for p in opts if p != "fast"]
                mag = float(nums[0]) if nums else 1.0
                if fast:  # LSHIFT in viewport.rs:176-186
                    mag *= ui["mov_speed_mul"]
                if cmd in ("q", "e"):
                    mag *= ui["vert_speed"]
                    if ui["invert_move"]:
                        mag = -mag
                else:
                    mag *= ui["mov_speed"]
                if cmd == "w":
                    rr.advance(mag)
                elif cmd == "s":
                    rr.advance(-mag)
                elif cmd == "a":
                    rr.strafe(-mag)
                elif cmd == "d":
                    rr.strafe(mag)
                elif cmd == "q":
                    rr.elevate(-mag)
                else:
                    rr.elevate(mag)
                present()
            elif cmd == "look":
                rr.look_around(*look_deltas(float(parts[1]),
                                            float(parts[2])))
                present()
            elif cmd == "settings":
                # print the names `set` accepts, not the internal keys
                for k, v in ui.items():
                    print(f"  {_alias.get(k, k)} = {v}")
            elif cmd == "set":
                key = parts[1].lower()
                if key in _set_keys:
                    ui[_set_keys[key]] = ui_clamp(_set_keys[key], parts[2])
                elif key in ("invert_h", "invert_v", "invert_move"):
                    ui[key] = parts[2].lower() in ("on", "1", "true")
                else:
                    print(f"unknown setting {key!r}")
            elif cmd == "drag":
                # continuous mouse-look (viewport.rs:81-247 cursor-moved):
                # every frame rotates the view, restarting accumulation,
                # so each launch is an all-primary sample
                dx, dy = look_deltas(float(parts[1]), float(parts[2]))
                n = int(parts[3]) if len(parts) > 3 else 8
                for _ in range(max(1, n)):
                    rr.look_around(dx, dy)
                    rr.draw_frame(pipelined=True)
                present(1)
            elif cmd == "frames":
                present(int(parts[1]) if len(parts) > 1 else 8)
            elif cmd == "mat" and len(parts) == 1:
                for i, m in enumerate(rr.materials()):
                    print(f"  [{i}] {m.name}: {m.mtype.display_name} "
                          f"ior={m.ior} metal={m.metal.display_name} "
                          f"diffuse_mul={m.diffuse_mul}")
            elif cmd == "mat":
                mid = int(parts[1])
                mat = rr.materials()[mid]
                field = parts[2].lower()
                if field == "type":
                    mat.mtype = mtypes[parts[3].lower()]
                elif field == "ior":
                    mat.ior = float(parts[3])
                elif field == "metal":
                    mat.metal = Metal[parts[3].upper()]
                elif field == "diffuse":
                    mat.diffuse_mul = tuple(int(v) for v in parts[3:6])
                elif field == "tex":
                    slot = parts[3].lower()
                    if slot not in ("diffuse", "roughness", "metalness",
                                    "opacity", "normal"):
                        raise ValueError(f"bad texture slot {slot!r}")
                    tid = int(parts[4])
                    if not 0 <= tid < len(rr.textures()):
                        raise ValueError(f"no texture {tid}")
                    setattr(mat, slot, tid)
                rr.change_material(mid, mat)
                present()
            elif cmd == "tex" and len(parts) == 1:
                for i, t in enumerate(rr.textures()):
                    print(f"  [{i}] {t.info.name or '(unnamed)'}: "
                          f"{t.info.width}x{t.info.height} "
                          f"{t.info.format.name} mips={len(t.data)}")
            elif cmd == "tex" and parts[1] == "add":
                import numpy as np

                from glaze_tpu_torch.core import Texture, TextureFormat, TextureInfo

                fmts = {"srgb": TextureFormat.RgbaSrgb,
                        "norm": TextureFormat.RgbaNorm,
                        "gray": TextureFormat.Gray}
                fmt = fmts[parts[3].lower()] if len(parts) > 3 else TextureFormat.RgbaSrgb
                pil = Image.open(parts[2])
                arr = np.asarray(pil.convert(
                    "L" if fmt == TextureFormat.Gray else "RGBA"), np.uint8)
                info = TextureInfo(parts[2].rsplit("/", 1)[-1],
                                   arr.shape[1], arr.shape[0], fmt)
                tid = rr.add_texture(Texture(info, [arr]))
                print(f"added texture [{tid}]", file=sys.stderr)
                present()
            elif cmd == "tex" and parts[1] == "del":
                rr.remove_texture(int(parts[2]))
                present()
            elif cmd == "tex" and parts[1] == "show":
                # texture pixel preview (the reference's imgui textures
                # window renders the texture via scene descriptors,
                # vulkan/imgui.rs:39-628; headless equivalent = PNG)
                tid = int(parts[2])
                t = rr.textures()[tid]
                out = (parts[3] if len(parts) > 3
                       else os.path.join(tempfile.gettempdir(),
                                         f"glaze_tex_{tid}.png"))
                Image.fromarray(t.data[0]).save(out)
                print(f"texture [{tid}] {t.info.width}x{t.info.height} "
                      f"{t.info.format.name} -> {out}", file=sys.stderr)
                if args.terminal:
                    import numpy as np

                    arr = t.data[0]
                    if arr.ndim == 2:
                        arr = np.stack([arr] * 3, -1)
                    print(_terminal_preview(arr[..., :3]))
            elif cmd == "tex" and parts[1] == "format":
                from glaze_tpu_torch.core import TextureFormat

                fmts = {"srgb": TextureFormat.RgbaSrgb,
                        "norm": TextureFormat.RgbaNorm,
                        "gray": TextureFormat.Gray}
                rr.set_texture_format(int(parts[2]), fmts[parts[3].lower()])
                present()
            elif cmd == "light" and len(parts) == 1:
                for i, l in enumerate(rr.lights()):
                    print(f"  [{i}] {l.name or '(unnamed)'}: "
                          f"{l.ltype.display_name} intensity={l.intensity}")
            elif cmd == "light" and parts[1] == "add":
                rr.update_light(len(rr.lights()),
                                Light(ltype=ltypes[parts[2].lower()]))
                present()
            elif cmd == "light" and parts[1] == "del":
                rr.remove_light(int(parts[2]))
                present()
            elif cmd == "light":
                lid = int(parts[1])
                light = rr.lights()[lid]
                field = parts[2].lower()
                if field == "intensity":
                    light.intensity = float(parts[3])
                elif field == "color":
                    light.color = Spectrum.from_rgb(
                        [float(v) for v in parts[3:6]], True)
                elif field == "pos":
                    import numpy as np

                    light.position = np.asarray(
                        [float(v) for v in parts[3:6]], np.float32)
                rr.update_light(lid, light)
                present()
            elif cmd == "raytrace":
                rr.use_raytracer = parts[1].lower() != "off"
                present()
            elif cmd == "denoise":
                rr.denoise = parts[1].lower() != "off"
                present()
            elif cmd == "integrator":
                from glaze_tpu_torch.render.renderer import Integrator

                rr._rt.set_integrator(Integrator(parts[1].lower()))
                present()
            elif cmd == "coherent":
                # per-renderer coherent-mode switch (off|frame|tile /
                # 0|1|2; default tile, renderer.default_coherent)
                arg = parts[1].lower()
                mode = {"off": 0, "frame": 1, "on": 1, "tile": 2}.get(
                    arg, arg)
                rr.coherent = int(mode)
                present()
            elif cmd == "scale":
                rr.set_render_scale(float(parts[1]))
                present()
            elif cmd == "exposure":
                rr._rt.set_exposure(float(parts[1]))
                rr._preview.set_exposure(float(parts[1]))
                present()
            elif cmd == "stats":
                print(f"  fps={rr.stats.fps:.2f}")
            elif cmd == "info":
                # device info window (ui.rs info_window; device.rs:403-448)
                from glaze_tpu_torch.instance import RayTraceInstance

                inst = RayTraceInstance.new(rr.device)
                if inst is None:
                    print("  no accelerated device")
                else:
                    print(f"  {inst.info}")
            elif cmd == "load":
                # background-thread scene load with progress while the
                # render loop keeps presenting (ui.rs:88-95 + 1101+)
                from glaze_tpu_torch.loader import BackgroundSceneLoader

                ld = BackgroundSceneLoader(parts[1])
                while not ld.done:
                    rr.draw_frame(pipelined=True)
                    print(f"\rloading {parts[1]}: {ld.stage} "
                          f"{ld.fraction * 100:3.0f}%", end="",
                          file=sys.stderr, flush=True)
                print(file=sys.stderr)
                if ld.error is not None:
                    print(f"load failed: {ld.error}", file=sys.stderr)
                else:
                    rr.change_scene(ld.result)
                    print(f"loaded {parts[1]}: "
                          f"{len(rr.materials())} materials, "
                          f"{len(rr.lights())} lights", file=sys.stderr)
                    present()
            elif cmd == "save":
                rr.save()
                print("scene updated in place", file=sys.stderr)
            elif cmd == "saveas":
                rr.save_as(parts[1])
                print(f"saved {parts[1]}", file=sys.stderr)
            elif cmd == "shot":
                Image.fromarray(rr.get_image()).save(parts[1])
            else:
                print(f"unknown command {cmd!r}; try 'help'")
        except (IndexError, ValueError, KeyError) as err:
            print(f"bad command: {err}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
