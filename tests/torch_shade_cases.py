"""Scenes and carries shared by the shade-kernel tests
(tests/test_torch_shade.py against JAX on the CPU,
tests/test_torch_kernel_cuda.py on the card).  Imports no jax.

The five scenes cover every branch of the shading: the cornell (diffuse,
a triangle light), the cornell with a mirror box and a glass sphere, a
small still life (alpha masks, the environment map and its light, all
six material kinds), the bumped scene (kd and bump textures) and the
cornell with a point, a spot and a directional light beside its
triangle light.  A carry is made from a numpy seed: lanes leave the
camera in random directions at mixed depths, some inactive, with random
throughput, radiance, MIS state and RNG words.
"""

import dataclasses

import numpy as np

SMALL_STILL_LIFE = dict(num_objects=40, num_cards=16)
SCENES = ("cornell", "specular", "still_life", "bumped", "delta_lights")
MAX_LEN = 6

# Light kinds of the delta lights added to the cornell's triangle light
# (render/lights.py).
LIGHT_POINT, LIGHT_DIR, LIGHT_SPOT = 1, 2, 3


def delta_light_rows():
    dn = np.asarray((0.2, -0.6, -1.0), np.float32)
    return [
        dict(kind=LIGHT_POINT, p0=(0.2, 1.7, -0.1), intensity=(6.0, 5.0, 3.5)),
        dict(kind=LIGHT_SPOT, p0=(0.0, 1.9, 0.0), normal=(0.0, -1.0, 0.0),
             intensity=(6.0, 5.0, 3.5), cos_angle=np.cos(np.deg2rad(40.0))),
        dict(kind=LIGHT_DIR, normal=dn / np.linalg.norm(dn),
             intensity=(1.5, 1.3, 1.0)),
    ]


def light_rows(table):
    """The rows of a LightTable (either package's) as build_light_table's
    dicts."""
    host = lambda x: np.asarray(x.cpu() if hasattr(x, "detach") else x)
    a = {k: host(getattr(table, k)) for k in (
        "kind", "p0", "p1", "p2", "normal", "intensity", "area",
        "cos_angle")}
    return [dict(kind=int(a["kind"][i]), p0=a["p0"][i], p1=a["p1"][i],
                 p2=a["p2"][i], normal=a["normal"][i],
                 intensity=a["intensity"][i], area=float(a["area"][i]),
                 cos_angle=float(a["cos_angle"][i]))
            for i in range(a["kind"].shape[0])]


def with_delta_lights(scene, build_light_table):
    """`scene` (a DeviceScene of either package) with the delta lights
    appended to its light table; `build_light_table(rows)` builds that
    package's table."""
    rows = light_rows(scene.lights) + delta_light_rows()
    kinds = tuple(sorted({r["kind"] for r in rows}))
    return dataclasses.replace(scene, lights=build_light_table(rows),
                               light_kinds=kinds)


def port_scene(name, device):
    """(DeviceScene, SceneMeta) of the port for one of SCENES."""
    from imbatracer_torch.render.lights import build_light_table
    from imbatracer_torch.scene import procedural as proc

    if name == "cornell":
        return proc.make_cornell_scene(device=device)
    if name == "specular":
        return proc.make_cornell_scene(mirror_box=True, glass_sphere=True,
                                       device=device)
    if name == "still_life":
        return proc.make_still_life_like(device=device, **SMALL_STILL_LIFE)
    if name == "bumped":
        return proc.make_bumped_scene(device=device)
    scene, meta = proc.make_cornell_scene(device=device)
    return with_delta_lights(
        scene, lambda rows: build_light_table(rows, device)), meta


def carry_arrays(meta, lanes, seed, mixed):
    """A PT carry as numpy arrays (state uint32, n_rays 0): rays from
    about the camera position into a cone around the view direction; with
    `mixed`, lanes at depths 0 .. MAX_LEN - 1 with random MIS state, else
    the camera's bounce-0 carry with random RNG words."""
    rs = np.random.RandomState(seed)
    org = (np.asarray(meta.cam_pos, np.float32)
           + rs.uniform(-0.05, 0.05, (lanes, 3))).astype(np.float32)
    d = np.asarray(meta.cam_dir, np.float32) + rs.normal(0.0, 0.35,
                                                         (lanes, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    state = rs.randint(1, 2**32, lanes, dtype=np.uint64).astype(np.uint32)
    c = dict(org=org, d=d, tmin=np.zeros(lanes, np.float32),
             throughput=np.ones((lanes, 3), np.float32),
             radiance=np.zeros((lanes, 3), np.float32),
             active=np.ones(lanes, bool), depth=np.zeros(lanes, np.int32),
             last_pdf=np.ones(lanes, np.float32),
             last_specular=np.ones(lanes, bool), state=state)
    if mixed:
        c.update(
            tmin=rs.uniform(0.0, 1e-3, lanes).astype(np.float32),
            throughput=rs.uniform(0.05, 1.0, (lanes, 3)).astype(np.float32),
            radiance=rs.uniform(0.0, 0.5, (lanes, 3)).astype(np.float32),
            active=rs.rand(lanes) < 0.85,
            depth=rs.randint(0, MAX_LEN, lanes).astype(np.int32),
            last_pdf=rs.uniform(0.05, 4.0, lanes).astype(np.float32),
            last_specular=rs.rand(lanes) < 0.3)
    return c


def torch_carry(arrays, device):
    """The port's carry of carry_arrays' arrays on `device`."""
    import torch

    c = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()
         if k != "state"}
    c["state"] = torch.as_tensor(arrays["state"].astype(np.int64),
                                 device=device)
    c["n_rays"] = torch.zeros((), dtype=torch.int64, device=device)
    return c


def dying_lanes(arrays, tri, center, radius, seed):
    """carry_arrays' `arrays` with half the lanes alive on entry and made
    to die at a camera bounce's first tests: every fourth lane from three
    bounding radii outside the scene pointing away from it (a miss), every
    fourth from half a unit in front of the triangle light `tri` (its p0,
    p1, p2 and normal, along which it emits) straight into it (an emitter
    hit).  `center`, `radius`: the scene's bounding sphere."""
    a = {k: v.copy() for k, v in arrays.items()}
    n = len(a["active"])
    rs = np.random.RandomState(seed)
    away = rs.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    lane = np.arange(n)
    miss, light = lane % 4 == 0, lane % 4 == 1
    a["org"][miss] = np.asarray(center) + 3.0 * radius * away[miss]
    a["d"][miss] = away[miss]
    p0, p1, p2, normal = (np.asarray(x, np.float64) for x in tri)
    u, v = rs.uniform(0.1, 0.45, n), rs.uniform(0.1, 0.45, n)
    on = p0 + u[:, None] * (p1 - p0) + v[:, None] * (p2 - p0)
    a["org"][light] = on[light] + 0.5 * normal
    a["d"][light] = -normal
    a["active"][miss | light] = True
    for k in ("org", "d"):
        a[k] = a[k].astype(np.float32)
    return a


def tri_light(scene):
    """(p0, p1, p2, normal) of a port scene's first triangle light, as
    numpy arrays."""
    import torch

    lt = scene.lights
    k = int(torch.nonzero(lt.kind == 0)[0, 0])
    return tuple(x[k].cpu().numpy() for x in (lt.p0, lt.p1, lt.p2,
                                              lt.normal))


def dead_band(scene, meta, band, lanes, seed):
    """A mixed-depth carry of a port scene with all of its lanes dead on
    entry ("all_dead"), every other one ("half_dead"), or half of them
    made to die at the bounce's miss or emitter test ("emitters":
    dying_lanes, every fourth a miss, every fourth an emitter)."""
    arrays = carry_arrays(meta, lanes, seed=seed, mixed=True)
    if band == "all_dead":
        arrays["active"][:] = False
    elif band == "half_dead":
        arrays["active"][::2] = False
    else:
        arrays = dying_lanes(arrays, tri_light(scene),
                             scene.bsphere.center.cpu().numpy(),
                             float(scene.bsphere.radius), seed)
    return arrays
