"""`.scene` text-format parser: the port's own copy of
imbatracer_tpu.io.scene_file.

Grammar: camera `pos/dir/up`; `mesh <obj>` with optional `accel <cache>`
(parsed, not used: the port keeps no BVH cache); lights `point_light`,
`dir_light`, `spot_light`; `env <hdr> <intensity...>`; `instance
<mesh-idx>` blocks with `pos/scale/rot` (Euler degrees).  If no instances
are listed, every mesh gets one identity instance.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class InstanceDesc:
    mesh_idx: int
    pos: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    rot: tuple = (0.0, 0.0, 0.0)


@dataclass
class LightDesc:
    kind: str                  # "point" | "dir" | "spot"
    params: tuple              # kind-specific floats


@dataclass
class SceneDesc:
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_dir: tuple = (0.0, 0.0, -1.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    mesh_paths: list = field(default_factory=list)
    accel_paths: list = field(default_factory=list)   # parallel to mesh_paths; "" = none
    lights: list = field(default_factory=list)
    env_path: str = ""
    env_intensity: tuple = (1.0, 1.0, 1.0)
    instances: list = field(default_factory=list)
    base_dir: str = ""


def parse_scene_file(path: str) -> SceneDesc:
    desc = SceneDesc(base_dir=os.path.dirname(os.path.abspath(path)))
    cur_instance = None

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cmd = tok[0]
            if cmd == "pos":
                v = tuple(float(x) for x in tok[1:4])
                if cur_instance is not None:
                    cur_instance.pos = v
                else:
                    desc.cam_pos = v
            elif cmd == "dir":
                desc.cam_dir = tuple(float(x) for x in tok[1:4])
            elif cmd == "up":
                desc.cam_up = tuple(float(x) for x in tok[1:4])
            elif cmd == "mesh":
                desc.mesh_paths.append(line.split(None, 1)[1])
                desc.accel_paths.append("")
                cur_instance = None
            elif cmd == "accel":
                if desc.accel_paths:
                    desc.accel_paths[-1] = line.split(None, 1)[1]
            elif cmd == "point_light":
                # pos(3) intensity(3)
                desc.lights.append(LightDesc("point", tuple(float(x) for x in tok[1:7])))
            elif cmd == "dir_light":
                # dir(3) intensity(3)
                desc.lights.append(LightDesc("dir", tuple(float(x) for x in tok[1:7])))
            elif cmd == "spot_light":
                # pos(3) dir(3) angle intensity(3)
                desc.lights.append(LightDesc("spot", tuple(float(x) for x in tok[1:11])))
            elif cmd == "env":
                parts = tok[1:]
                # Last 1 or 3 numeric fields are intensity; the rest is a path
                # (paths may contain spaces only in theory; keep it simple).
                desc.env_path = parts[0]
                vals = [float(x) for x in parts[1:]] if len(parts) > 1 else [1.0]
                if len(vals) == 1:
                    desc.env_intensity = (vals[0],) * 3
                else:
                    desc.env_intensity = tuple(vals[:3])
            elif cmd == "instance":
                cur_instance = InstanceDesc(mesh_idx=int(tok[1]))
                desc.instances.append(cur_instance)
            elif cmd == "scale" and cur_instance is not None:
                cur_instance.scale = tuple(float(x) for x in tok[1:4])
            elif cmd == "rot" and cur_instance is not None:
                cur_instance.rot = tuple(float(x) for x in tok[1:4])

    if not desc.instances:
        desc.instances = [InstanceDesc(mesh_idx=i) for i in range(len(desc.mesh_paths))]
    return desc
