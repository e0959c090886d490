# Frozen copy of glaze_tpu_torch/scenes.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref, the
# grid scene and the OBJ writer left out.
"""Procedural scenes built with the port's own core classes.

* :class:`SponzaScene` -- the repository's Sponza-class benchmark scene
  (about 262k triangles): a two-story colonnaded atrium with arches,
  hanging curtains and reflective props, all six material families and
  all four light types. Its curtain material carries an opacity map.
  A copy of ``tools/make_sponza.py``'s scene.
* :class:`MatRowScene` -- the golden scene: six spheres, one per BSDF
  family, on a checkered floor under OMNI + AREA + SKY lights. A copy of
  ``tests/golden_scenes.py``'s scene; ``tests/goldens/*.npz`` hold the
  JAX package's renders of it at GOLDEN_W x GOLDEN_H.

Both are duck-typed ParsedScenes (``vertices()``, ``meshes()`` ...), so
they go straight into the renderer or through the port's Serializer
(:func:`write_glaze`).
"""

from __future__ import annotations

import numpy as np

from benchmark.ref.core import (
    Camera,
    Light,
    LightType,
    Material,
    MaterialType,
    Mesh,
    MeshInstance,
    Metal,
    PerspectiveCam,
    Spectrum,
    Texture,
    TextureFormat,
    TextureInfo,
    Transform,
    Vertex,
)
from benchmark.ref.parser import Meta, Serializer

# Atrium dimensions
LEN, WID, HEI = 24.0, 10.0, 9.0


class _Geo:
    """Accumulates positions/normals/uvs + per-material index lists."""

    def __init__(self):
        self.pos = []
        self.nrm = []
        self.uv = []
        self.idx = {}  # material -> index list

    def grid(self, corner, du, dv, nu, nv, material, displace=None,
             uv_scale=1.0):
        """Subdivided quad patch: corner + u*du + v*dv, (nu x nv) cells."""
        corner = np.asarray(corner, np.float32)
        du = np.asarray(du, np.float32)
        dv = np.asarray(dv, np.float32)
        base = len(self.pos)
        n = np.cross(du, dv)
        n = n / max(np.linalg.norm(n), 1e-20)
        us = np.linspace(0, 1, nu + 1, dtype=np.float32)
        vs = np.linspace(0, 1, nv + 1, dtype=np.float32)
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        p = (corner[None, None] + uu[..., None] * du[None, None]
             + vv[..., None] * dv[None, None])
        if displace is not None:
            p = p + displace(uu, vv)[..., None] * n[None, None]
        self.pos.extend(p.reshape(-1, 3))
        self.nrm.extend(np.broadcast_to(n, ((nu + 1) * (nv + 1), 3)))
        self.uv.extend(
            np.stack([uu * uv_scale, vv * uv_scale], -1).reshape(-1, 2))
        ii = self.idx.setdefault(material, [])
        for i in range(nu):
            for j in range(nv):
                a = base + i * (nv + 1) + j
                b = a + (nv + 1)
                ii.extend([a, b, b + 1, a, b + 1, a + 1])

    def revolve(self, centre, radius_fn, y0, y1, rings, segs, material):
        """Surface of revolution around a vertical axis (columns, pots)."""
        centre = np.asarray(centre, np.float32)
        base = len(self.pos)
        ys = np.linspace(y0, y1, rings + 1, dtype=np.float32)
        th = np.linspace(0, 2 * np.pi, segs + 1, dtype=np.float32)
        for yi, y in enumerate(ys):
            r = radius_fn((y - y0) / max(y1 - y0, 1e-9))
            for t in th:
                c, s = np.cos(t), np.sin(t)
                self.pos.append(centre + np.asarray([r * c, y, r * s]))
                self.nrm.append(np.asarray([c, 0.0, s], np.float32))
                self.uv.append(np.asarray([t / (2 * np.pi) * 4, y], np.float32))
        ii = self.idx.setdefault(material, [])
        for i in range(rings):
            for j in range(segs):
                a = base + i * (segs + 1) + j
                b = a + (segs + 1)
                ii.extend([a, b, b + 1, a, b + 1, a + 1])

    def sphere(self, centre, radius, rings, segs, material):
        centre = np.asarray(centre, np.float32)
        base = len(self.pos)
        for i in range(rings + 1):
            phi = np.pi * i / rings
            for j in range(segs + 1):
                th = 2 * np.pi * j / segs
                n = np.asarray([
                    np.sin(phi) * np.cos(th), np.cos(phi),
                    np.sin(phi) * np.sin(th),
                ], np.float32)
                self.pos.append(centre + radius * n)
                self.nrm.append(n)
                self.uv.append(np.asarray([j / segs, i / rings], np.float32))
        ii = self.idx.setdefault(material, [])
        for i in range(rings):
            for j in range(segs):
                a = base + i * (segs + 1) + j
                b = a + (segs + 1)
                ii.extend([a, b, b + 1, a, b + 1, a + 1])

    def n_tris(self):
        return sum(len(v) for v in self.idx.values()) // 3


def _checker_tex(n=256, c0=200, c1=90):
    i = np.arange(n)
    chk = ((i[:, None] // 32 + i[None, :] // 32) % 2).astype(np.uint8)
    img = np.zeros((n, n, 4), np.uint8)
    img[..., :3] = np.where(chk[..., None] > 0, c1, c0)
    img[..., 3] = 255
    return img


def _noise_tex(n=256, seed=3, lo=110, hi=190, tint=(1.0, 0.92, 0.8)):
    rng = np.random.default_rng(seed)
    base = rng.random((n // 8, n // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img = (lo + (hi - lo) * img)
    out = np.zeros((n, n, 4), np.uint8)
    for k in range(3):
        out[..., k] = np.clip(img * tint[k], 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def _cutout_tex(n=128):
    """Gray opacity map: lace-like cutout pattern (circular holes on a
    grid plus scalloped bottom edge). Drives the rahit-equivalent
    alpha-tested transparency (raytrace_hit.rahit:1-39): real Sponza's
    foliage/fabric pays this cost on every closest-hit AND NEE shadow
    ray, so the bench scene must too (VERDICT r3 #5)."""
    i = np.arange(n, dtype=np.float32)
    yy, xx = np.meshgrid(i, i, indexing="ij")
    cell = n / 8.0
    cx = (xx % cell) - cell / 2
    cy = (yy % cell) - cell / 2
    holes = (cx * cx + cy * cy) < (0.32 * cell) ** 2
    # scalloped hem along v=1 (the curtain bottom)
    hem = yy / n > 0.92 + 0.05 * np.sin(xx / n * 6.28 * 8)
    alpha = np.where(holes | hem, 0, 255).astype(np.uint8)
    return alpha


def _sky_tex(w=256, h=128, sun=(0.35, 0.25)):
    """Equirect sky: blue gradient + bright sun disk + warm horizon."""
    u = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    zen = np.asarray([90, 140, 230], np.float32)
    hor = np.asarray([240, 210, 160], np.float32)
    t = np.clip(np.abs(v - 0.5) * 2, 0, 1)
    img = hor[None, None] + (zen - hor)[None, None] * (1 - t[..., None])
    d2 = ((u - sun[0]) ** 2 + (v - sun[1]) ** 2)
    disk = np.exp(-d2 / 0.0008)[..., None]
    img = img + disk * np.asarray([900, 850, 700], np.float32)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., :3] = np.clip(img, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


MAT_FLOOR = 1
MAT_WALL = 2
MAT_COLUMN = 3
MAT_TRIM = 4  # metal
MAT_CURTAIN = 5
MAT_GLASS = 6
MAT_MIRROR = 7
MAT_PANEL = 8  # emissive


def build_geometry():
    g = _Geo()
    L, W, H = LEN, WID, HEI

    # floor + ceiling (finely subdivided so shading has real area)
    g.grid([-L / 2, 0, -W / 2], [L, 0, 0], [0, 0, W], 72, 30, MAT_FLOOR,
           uv_scale=8.0)
    g.grid([-L / 2, H, W / 2], [L, 0, 0], [0, 0, -W], 48, 20, MAT_WALL,
           uv_scale=6.0)
    # outer walls
    rough = lambda uu, vv: 0.03 * np.sin(uu * 47.0) * np.cos(vv * 31.0)
    g.grid([-L / 2, 0, -W / 2], [L, 0, 0], [0, H, 0], 64, 24, MAT_WALL,
           displace=rough, uv_scale=6.0)
    g.grid([L / 2, 0, W / 2], [-L, 0, 0], [0, H, 0], 64, 24, MAT_WALL,
           displace=rough, uv_scale=6.0)
    g.grid([-L / 2, 0, W / 2], [0, 0, -W], [0, H, 0], 28, 24, MAT_WALL,
           displace=rough, uv_scale=4.0)
    g.grid([L / 2, 0, -W / 2], [0, 0, W], [0, H, 0], 28, 24, MAT_WALL,
           displace=rough, uv_scale=4.0)

    # two-story colonnades: 2 rows x 11 columns x 2 floors
    cols_x = np.linspace(-L / 2 + 1.5, L / 2 - 1.5, 11)
    fluting = 24
    for floor_y, hh in ((0.0, 4.2), (4.8, 3.6)):
        for zc in (-W / 2 + 1.6, W / 2 - 1.6):
            for xi, xc in enumerate(cols_x):
                mat = MAT_TRIM if xi % 5 == 2 else MAT_COLUMN

                def rad(t):
                    return 0.32 * (1.0 + 0.08 * np.cos(t * 6.3 * 2)) * (
                        1.0 - 0.12 * t
                    )

                g.revolve([xc, 0, zc], rad, floor_y, floor_y + hh,
                          24, 64, mat)
                # capital + base tori (squashed spheres)
                g.sphere([xc, floor_y + hh + 0.12, zc], 0.42, 6, 24, mat)
                g.sphere([xc, floor_y + 0.05, zc], 0.40, 6, 24, mat)
        # architrave beams above each row
        for zc in (-W / 2 + 1.6, W / 2 - 1.6):
            g.grid([-L / 2 + 1.0, floor_y + hh + 0.3, zc - 0.3],
                   [L - 2.0, 0, 0], [0, 0, 0.6], 60, 3, MAT_COLUMN,
                   uv_scale=10.0)
            g.grid([-L / 2 + 1.0, floor_y + hh + 0.9, zc - 0.35],
                   [L - 2.0, 0, 0], [0, 0, 0.7], 60, 3, MAT_COLUMN,
                   uv_scale=10.0)

    # arches between ground-floor columns (half-cylinders bridging gaps)
    for zc in (-W / 2 + 1.6, W / 2 - 1.6):
        for xi in range(len(cols_x) - 1):
            x0, x1 = cols_x[xi], cols_x[xi + 1]
            xm, span = (x0 + x1) / 2, (x1 - x0) / 2
            base = len(g.pos)
            segs, rings = 24, 6
            for i in range(rings + 1):
                zoff = -0.25 + 0.5 * i / rings
                for j in range(segs + 1):
                    th = np.pi * j / segs
                    x = xm - span * np.cos(th)
                    y = 3.6 + 0.9 * np.sin(th)
                    g.pos.append(np.asarray([x, y, zc + zoff], np.float32))
                    g.nrm.append(np.asarray(
                        [np.cos(th), -np.sin(th), 0], np.float32))
                    g.uv.append(np.asarray([j / segs * 3, i / rings],
                                           np.float32))
            ii = g.idx.setdefault(MAT_WALL, [])
            for i in range(rings):
                for j in range(segs):
                    a = base + i * (segs + 1) + j
                    b = a + (segs + 1)
                    ii.extend([a, b, b + 1, a, b + 1, a + 1])

    # hanging curtains (wavy sheets) down the upper gallery
    rngc = np.random.default_rng(11)
    for k in range(10):
        xc = -L / 2 + 2.4 + k * (L - 4.8) / 9
        zc = (-1 if k % 2 else 1) * (W / 2 - 2.4)
        ph = float(rngc.random() * 6.28)

        def wave(uu, vv, ph=ph):
            return 0.25 * np.sin(uu * 9.0 + ph) * (1 - vv * 0.5)

        g.grid([xc - 0.9, 8.4, zc], [1.8, 0, 0], [0, -3.4, 0], 44, 64,
               MAT_CURTAIN, displace=wave, uv_scale=2.0)

    # props: glass/mirror spheres and stone pots down the middle
    for k in range(8):
        xc = -L / 2 + 2.5 + k * (L - 5.0) / 7
        mat = (MAT_GLASS, MAT_MIRROR, MAT_COLUMN, MAT_TRIM)[k % 4]
        g.sphere([xc, 0.75, 0.0], 0.72, 24, 36, mat)
        g.revolve([xc, 0, (W / 2 - 3.2)],
                  lambda t: 0.35 + 0.25 * np.sin(t * 3.1), 0.0, 1.2,
                  14, 36, MAT_COLUMN)

    # emissive ceiling panel (AREA light resource)
    g.grid([-1.5, H - 0.05, -1.0], [3.0, 0, 0], [0, 0, 2.0], 2, 2,
           MAT_PANEL)
    return g


class SponzaScene:
    """Duck-typed ParsedScene."""

    def __init__(self):
        g = build_geometry()
        self._pos = np.asarray(g.pos, np.float32)
        self._nrm = np.asarray(g.nrm, np.float32)
        self._uv = np.asarray(g.uv, np.float32)
        self._idx = g.idx

    def vertices(self):
        return [Vertex(p, n, t) for p, n, t in
                zip(self._pos, self._nrm, self._uv)]

    def vertices_np(self):
        return self._pos, self._nrm, self._uv

    def meshes(self):
        return [Mesh(i, np.asarray(idx, np.uint32), mat)
                for i, (mat, idx) in enumerate(sorted(self._idx.items()))]

    def transforms(self):
        return [Transform.identity()]

    def instances(self):
        return [MeshInstance(i, 0) for i in range(len(self._idx))]

    def cameras(self):
        return [Camera.Perspective(PerspectiveCam(
            position=[-LEN / 2 + 1.2, 1.7, 0.0],
            target=[LEN / 2, 2.6, 0.0],
            up=[0.0, 1.0, 0.0],
        ))]

    def textures(self):
        return [
            Texture.default(),
            Texture(TextureInfo("checker", 256, 256, TextureFormat.RgbaSrgb),
                    [_checker_tex()]),
            Texture(TextureInfo("stone", 256, 256, TextureFormat.RgbaSrgb),
                    [_noise_tex(seed=3)]),
            Texture(TextureInfo("fabric", 256, 256, TextureFormat.RgbaSrgb),
                    [_noise_tex(seed=9, lo=60, hi=160, tint=(1.0, 0.45, 0.4))]),
            Texture(TextureInfo("sky", 256, 128, TextureFormat.RgbaSrgb),
                    [_sky_tex()]),
            Texture(TextureInfo("cutout", 128, 128, TextureFormat.Gray),
                    [_cutout_tex()]),
        ]

    def materials(self):
        return [
            Material(name="default"),
            Material(name="floor", mtype=MaterialType.UBER, diffuse=1,
                     roughness_mul=0.35),
            Material(name="wall", mtype=MaterialType.LAMBERT, diffuse=2),
            Material(name="column", mtype=MaterialType.LAMBERT, diffuse=2),
            Material(name="trim", mtype=MaterialType.METAL,
                     roughness_mul=0.2),
            # opacity-mapped: alpha < 0.5 hits are skipped via re-trace
            # rounds (render/integrator.py trace_alpha), for camera,
            # bounce AND NEE shadow rays — the rahit cost real Sponza
            # pays on foliage (acceleration.rs:137-141 drops the OPAQUE
            # flag exactly when a material has an opacity map)
            Material(name="curtain", mtype=MaterialType.LAMBERT, diffuse=3,
                     opacity=5),
            Material(name="glass", mtype=MaterialType.GLASS, ior=1.5),
            Material(name="mirror", mtype=MaterialType.MIRROR),
            Material(name="panel", mtype=MaterialType.LAMBERT,
                     emissive_col=(255, 244, 224)),
        ]

    def lights(self):
        return [
            Light(ltype=LightType.SKY, name="sky", resource_id=4,
                  intensity=1.0),
            Light(ltype=LightType.SUN, name="sun",
                  color=Spectrum.white(),
                  direction=np.asarray([0.35, -0.8, 0.25], np.float32),
                  intensity=3.0),
            Light(ltype=LightType.OMNI, name="fill",
                  color=Spectrum.white(),
                  position=np.asarray([0.0, 5.0, 0.0], np.float32),
                  intensity=6.0),
            Light(ltype=LightType.AREA, name="panel", resource_id=8,
                  intensity=4.0),
        ]

    def meta(self):
        return Meta(scene_centre=[0.0, HEI / 2, 0.0],
                    scene_radius=float(np.linalg.norm([LEN, HEI, WID]) / 2),
                    exposure=1.0)


GOLDEN_W, GOLDEN_H = 96, 48
GOLDEN_SPP = 8
GOLDEN_SEED = 1234


def _sphere(centre, radius, rings=12, segs=18):
    pos, nrm, uv, idx = [], [], [], []
    for i in range(rings + 1):
        phi = np.pi * i / rings
        for j in range(segs + 1):
            th = 2 * np.pi * j / segs
            n = np.asarray([np.sin(phi) * np.cos(th), np.cos(phi),
                            np.sin(phi) * np.sin(th)], np.float32)
            pos.append(np.asarray(centre, np.float32) + radius * n)
            nrm.append(n)
            uv.append(np.asarray([j / segs, i / rings], np.float32))
    for i in range(rings):
        for j in range(segs):
            a = i * (segs + 1) + j
            b = a + segs + 1
            idx.extend([a, b, b + 1, a, b + 1, a + 1])
    return pos, nrm, uv, idx


class MatRowScene:
    """Duck-typed ParsedScene."""

    FAMILIES = [
        ("lambert", MaterialType.LAMBERT),
        ("mirror", MaterialType.MIRROR),
        ("glass", MaterialType.GLASS),
        ("metal", MaterialType.METAL),
        ("frosted", MaterialType.FROSTED),
        ("uber", MaterialType.UBER),
    ]

    def __init__(self):
        self._pos, self._nrm, self._uv = [], [], []
        self._meshes = []
        n_mat = len(self.FAMILIES)
        for k in range(n_mat):
            x = -5.0 + 2.0 * k
            pos, nrm, uv, idx = _sphere([x, 1.0, 0.0], 0.85)
            base = len(self._pos)
            self._pos.extend(pos)
            self._nrm.extend(nrm)
            self._uv.extend(uv)
            self._meshes.append(
                Mesh(k, [i + base for i in idx], k + 1))
        # floor (material n_mat+1) + emissive panel (n_mat+2)
        base = len(self._pos)
        for p, uvc in (([-8, 0, -4], [0, 0]), ([8, 0, -4], [8, 0]),
                       ([8, 0, 4], [8, 4]), ([-8, 0, 4], [0, 4])):
            self._pos.append(np.asarray(p, np.float32))
            self._nrm.append(np.asarray([0, 1, 0], np.float32))
            self._uv.append(np.asarray(uvc, np.float32))
        self._meshes.append(Mesh(n_mat, [base, base + 1, base + 2,
                                         base, base + 2, base + 3],
                                 n_mat + 1))
        base = len(self._pos)
        for p in ([-1.5, 5.5, -1], [1.5, 5.5, -1], [1.5, 5.5, 1],
                  [-1.5, 5.5, 1]):
            self._pos.append(np.asarray(p, np.float32))
            self._nrm.append(np.asarray([0, -1, 0], np.float32))
            self._uv.append(np.asarray([0, 0], np.float32))
        self._meshes.append(Mesh(n_mat + 1, [base, base + 2, base + 1,
                                             base, base + 3, base + 2],
                                 n_mat + 2))

    def vertices(self):
        return [Vertex(p, n, t) for p, n, t in
                zip(self._pos, self._nrm, self._uv)]

    def meshes(self):
        return self._meshes

    def transforms(self):
        return [Transform.identity()]

    def instances(self):
        return [MeshInstance(m.id, 0) for m in self._meshes]

    def cameras(self):
        return [Camera.Perspective(PerspectiveCam(
            position=[0.0, 2.2, 7.5], target=[0.0, 1.0, 0.0],
            up=[0.0, 1.0, 0.0]))]

    def textures(self):
        i = np.arange(64)
        chk = ((i[:, None] // 8 + i[None, :] // 8) % 2).astype(np.uint8)
        floor = np.zeros((64, 64, 4), np.uint8)
        floor[..., :3] = np.where(chk[..., None] > 0, 70, 200)
        floor[..., 3] = 255
        v = np.linspace(0, 1, 32, np.float32)[:, None]
        sky = np.zeros((32, 64, 4), np.uint8)
        sky[..., 0] = (120 + 100 * v).astype(np.uint8)
        sky[..., 1] = (160 + 60 * v).astype(np.uint8)
        sky[..., 2] = 230
        sky[..., 3] = 255
        return [
            Texture.default(),
            Texture(TextureInfo("floor", 64, 64, TextureFormat.RgbaSrgb),
                    [floor]),
            Texture(TextureInfo("sky", 64, 32, TextureFormat.RgbaSrgb),
                    [sky]),
        ]

    def materials(self):
        mats = [Material(name="default")]
        for name, mtype in self.FAMILIES:
            m = Material(name=name, mtype=mtype, roughness_mul=0.3)
            if mtype == MaterialType.METAL:
                m.metal = Metal.GOLD
            if mtype in (MaterialType.GLASS, MaterialType.FROSTED):
                m.ior = 1.5
            mats.append(m)
        mats.append(Material(name="floor", mtype=MaterialType.LAMBERT,
                             diffuse=1))
        mats.append(Material(name="panel", mtype=MaterialType.LAMBERT,
                             emissive_col=(255, 240, 220)))
        return mats

    def lights(self):
        n_mat = len(self.FAMILIES)
        return [
            Light(ltype=LightType.OMNI, name="key", color=Spectrum.white(),
                  position=np.asarray([3.0, 6.0, 5.0], np.float32),
                  intensity=40.0),
            Light(ltype=LightType.AREA, name="panel",
                  resource_id=n_mat + 2, intensity=4.0),
            Light(ltype=LightType.SKY, name="sky", resource_id=2,
                  intensity=1.0),
        ]

    def meta(self):
        return Meta(scene_centre=[0, 1, 0], scene_radius=10.0, exposure=1.0)


def write_glaze(scene, path):
    """Serializes a duck-typed scene to a ``.glaze`` file."""
    (Serializer(path)
     .with_vertices(scene.vertices())
     .with_meshes(scene.meshes())
     .with_transforms(scene.transforms())
     .with_instances(scene.instances())
     .with_cameras(scene.cameras())
     .with_textures(scene.textures())
     .with_materials(scene.materials())
     .with_lights(scene.lights())
     .with_metadata(scene.meta())
     .serialize())
