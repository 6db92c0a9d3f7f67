"""The still life's scene description: a frozen copy of the program's
procedural generator `scene/procedural.make_still_life_like` (the 1080p
stand-in for the upstream's still_life.obj), stopped where it hands its
arrays to the scene build.  The benchmark gives the same `RawScene` to
the program's build and to the reference.

The geometry, materials, lights, mask texture and sky are made by the
same construction from the same seed, so the arrays are those the
program's own generator makes (tests under `rtbench/tests/` compare
them).
"""

from __future__ import annotations

import numpy as np

from . import lights as light_mod
from . import materials as mat_mod
from .scene import RawScene

_BASE = dict(ks=(0, 0, 0), tf=(0, 0, 0), ns=1.0, ior=1.0, emit=(0, 0, 0),
             kd_tex=-1, bump_tex=-1, mask_tex=-1)


def _quad(p00, p10, p11, p01):
    """Two CCW triangles for a quad given corners in order."""
    return [(p00, p10, p11), (p00, p11, p01)]


def _arrays(tris):
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    mat_id = np.asarray([t[3] for t in tris], np.int32)
    n = np.cross(v1 - v0, v2 - v0)
    gn = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                         1e-20)).astype(np.float32)
    F = len(tris)
    zeros2 = np.zeros((F, 2), np.float32)
    attrs = dict(
        n0=gn, n1=gn, n2=gn, uv0=zeros2, uv1=zeros2, uv2=zeros2,
        mat_id=mat_id, light_id=np.full(F, -1, np.int32),
        inst_id=np.zeros(F, np.int32), local_id=np.arange(F, dtype=np.int32),
    )
    return v0, v1, v2, mat_id, attrs


def _tri_lights(v0, v1, v2, mat_id, attrs, light_mat, intensity):
    """One TRI light row per triangle of the emissive material."""
    rows = []
    for ti in np.nonzero(mat_id == light_mat)[0]:
        nn = np.cross(v1[ti] - v0[ti], v2[ti] - v0[ti])
        area = 0.5 * np.linalg.norm(nn)
        attrs["light_id"][ti] = len(rows)
        rows.append(dict(kind=light_mod.LIGHT_TRI, p0=v0[ti], p1=v1[ti],
                         p2=v2[ti], normal=nn / (2 * area),
                         intensity=intensity, area=area))
    return rows


def _disc_mask(m: int = 64):
    """(m, m, 3) mask image: opaque (white) inside radius 0.5 of the
    card centre, transparent (black) outside."""
    yy, xx = np.mgrid[0:m, 0:m]
    disc = (((xx + 0.5) / m - 0.5) ** 2 + ((yy + 0.5) / m - 0.5) ** 2
            <= 0.25)
    return np.broadcast_to(
        np.where(disc[..., None], 1.0, 0.0).astype(np.float32),
        (m, m, 3)).copy()


def _random_card(rs, S, y_lo, y_hi, h_lo, h_hi):
    """Corners of a randomly oriented square card (make_leaf_scene)."""
    c = np.array([rs.uniform(-S, S), rs.uniform(y_lo, y_hi),
                  rs.uniform(-S, S)])
    a, b = rs.randn(3), rs.randn(3)
    a /= np.linalg.norm(a)
    b -= a * np.dot(a, b)
    b /= np.linalg.norm(b)
    h = rs.uniform(h_lo, h_hi)
    p00, p10 = c - a * h - b * h, c + a * h - b * h
    p11, p01 = c + a * h + b * h, c - a * h + b * h
    return tuple(p00), tuple(p10), tuple(p11), tuple(p01)


_CARD_UV = [((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))]


def make_still_life_like(num_objects: int = 8300, num_cards: int = 400,
                         seed: int = 3, with_env: bool = True,
                         specular_share: bool = True) -> RawScene:
    """The 1080p still-life proxy: an Oren-Nayar ground plane under an HDR
    sky with a bright sun disc, one floating area light, `num_objects`
    boxes (12 triangles each) over the full material set (diffuse,
    mirror, glass, glossy, phong, Oren-Nayar) and `num_cards` disc-masked
    foliage cards; 100,404 triangles at the defaults.  `with_env`,
    `specular_share` and `num_cards=0` drop the env light, the non-
    diffuse kinds and the masked cards."""
    rs = np.random.RandomState(seed)
    tris = []
    S = 30.0
    (floor_m, white, red, green, mirror_m, glass_m, glossy_m, phong_m,
     onayar_m, leaf_m, lightm) = range(11)

    def add(quads, mat):
        for t in quads:
            tris.append((*t, mat))

    add(_quad((-S, 0, S), (S, 0, S), (S, 0, -S), (-S, 0, -S)), floor_m)
    add(_quad((-4, 24.0, -4), (4, 24.0, -4), (4, 24.0, 4), (-4, 24.0, 4)),
        lightm)
    if specular_share:
        mats = [white, red, green, mirror_m, glass_m, glossy_m, phong_m,
                onayar_m]
        probs = [0.30, 0.14, 0.14, 0.08, 0.08, 0.10, 0.08, 0.08]
    else:
        mats, probs = [white, red, green], [0.5, 0.25, 0.25]
    for _ in range(num_objects):
        c = (rs.uniform(-S, S), rs.uniform(0.2, 8.0), rs.uniform(-S, S))
        sz = tuple(rs.uniform(0.2, 1.2, 3))
        _add_box(tris, center=c, size=sz, angle_deg=rs.uniform(0, 360),
                 mat=int(rs.choice(mats, p=probs)))
    n_before = len(tris)
    for _ in range(num_cards):
        add(_quad(*_random_card(rs, S, 6.0, 12.0, 0.4, 1.0)), leaf_m)

    v0, v1, v2, mat_id, attrs = _arrays(tris)
    F = len(tris)
    attrs.update({k: np.zeros((F, 2), np.float32)
                  for k in ("uv0", "uv1", "uv2")})
    for k in range(n_before, F):
        for key, val in zip(("uv0", "uv1", "uv2"),
                            _CARD_UV[(k - n_before) % 2]):
            attrs[key][k] = val
    emit_intensity = (400.0, 380.0, 330.0)
    mat_rows = [
        dict(_BASE, kind=mat_mod.MAT_OREN_NAYAR, kd=(0.55, 0.5, 0.42),
             ns=20.0),                                          # floor
        dict(_BASE, kind=mat_mod.MAT_DIFFUSE, kd=(0.7, 0.7, 0.7)),
        dict(_BASE, kind=mat_mod.MAT_DIFFUSE, kd=(0.6, 0.1, 0.05)),
        dict(_BASE, kind=mat_mod.MAT_DIFFUSE, kd=(0.1, 0.5, 0.1)),
        dict(_BASE, kind=mat_mod.MAT_MIRROR, kd=(0, 0, 0),
             ks=(0.9, 0.9, 0.9), ns=1000.0),
        dict(_BASE, kind=mat_mod.MAT_GLASS, kd=(0, 0, 0), ks=(1, 1, 1),
             tf=(1, 1, 1), ior=1.5),
        dict(_BASE, kind=mat_mod.MAT_GLOSSY, kd=(0.3, 0.25, 0.1),
             ks=(0.6, 0.6, 0.6), ns=80.0),
        dict(_BASE, kind=mat_mod.MAT_PHONG, kd=(0.2, 0.2, 0.45),
             ks=(0.5, 0.5, 0.5), ns=30.0),
        dict(_BASE, kind=mat_mod.MAT_OREN_NAYAR, kd=(0.5, 0.35, 0.2),
             ns=40.0),
        dict(_BASE, kind=mat_mod.MAT_DIFFUSE, kd=(0.15, 0.45, 0.1),
             mask_tex=0),                                       # leaf cards
        dict(_BASE, kind=mat_mod.MAT_DIFFUSE, kd=(0.8, 0.8, 0.8),
             emit=emit_intensity),
    ]
    if not specular_share:
        mat_rows[floor_m] = dict(_BASE, kind=mat_mod.MAT_DIFFUSE,
                                 kd=(0.55, 0.5, 0.42))
    light_rows = _tri_lights(v0, v1, v2, mat_id, attrs, lightm,
                             emit_intensity)

    # HDR sky: horizon-to-zenith gradient + a sun disc ~200x the sky.
    env = None
    if with_env:
        eh, ew = 64, 128
        tt = (np.arange(eh, dtype=np.float32) + 0.5) / eh      # 0=up pole
        sky = np.zeros((eh, ew, 3), np.float32)
        zen = np.array([0.25, 0.45, 0.9], np.float32)
        hor = np.array([0.9, 0.8, 0.7], np.float32)
        sky[:] = zen[None, None] * (1 - tt)[:, None, None] + \
            hor[None, None] * tt[:, None, None]
        sy, sx = int(eh * 0.28), int(ew * 0.8)
        sky[max(sy - 1, 0): sy + 2, max(sx - 1, 0): sx + 2] = (180.0, 160.0,
                                                               120.0)
        env = sky
        light_rows.append(dict(kind=light_mod.LIGHT_ENV, intensity=(1, 1, 1)))

    return RawScene(v0=v0, v1=v1, v2=v2, attrs=attrs, mat_rows=mat_rows,
                    light_rows=light_rows, textures=[_disc_mask()],
                    env_image=env, env_intensity=(1.0, 1.0, 1.0),
                    cam_pos=(0.0, 10.0, 42.0), cam_dir=(0.0, -0.18, -1.0),
                    cam_up=(0.0, 1.0, 0.0))


def _add_box(tris, center, size, angle_deg, mat):
    cx, cy, cz = center
    sx, sy, sz = size[0] / 2, size[1] / 2, size[2] / 2
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)

    def rot(p):
        x, y, z = p
        return (cx + c * x + s * z, cy + y, cz - s * x + c * z)

    lo, hi = (-sx, -sy, -sz), (sx, sy, sz)
    p = {}
    for i, (x, y, z) in enumerate(
        [(lo[0], lo[1], hi[2]), (hi[0], lo[1], hi[2]), (hi[0], lo[1], lo[2]),
         (lo[0], lo[1], lo[2]), (lo[0], hi[1], hi[2]), (hi[0], hi[1], hi[2]),
         (hi[0], hi[1], lo[2]), (lo[0], hi[1], lo[2])]
    ):
        p[i] = rot((x, y, z))

    quads = [
        (p[4], p[5], p[6], p[7]),  # top
        (p[0], p[3], p[2], p[1]),  # bottom
        (p[0], p[1], p[5], p[4]),  # front
        (p[2], p[3], p[7], p[6]),  # back
        (p[1], p[2], p[6], p[5]),  # right
        (p[3], p[0], p[4], p[7]),  # left
    ]
    for q in quads:
        for t in _quad(*q):
            tris.append((*t, mat))
