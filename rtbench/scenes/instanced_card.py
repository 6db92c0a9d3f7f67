"""The instanced scene: the frozen writer (`reference/card.py`) writes
the `.scene` file with its OBJ, MTL, PNG and HDR files into the run's
temporary directory; the program builds it with `scene/build.build_scene`
(the CLI's path, which takes two-level instancing for it), and the
reference reads the same files with its own reader
(`reference/sceneio.py`)."""

from __future__ import annotations

import os

from ..reference import card, sceneio

TRIANGLE_BYTES = 36      # three float32 vertices
INSTANCE_BYTES = 96      # a 3x4 float32 matrix and its inverse


def prepare(config: dict, workdir: str) -> str:
    return card.write_instanced_scene(os.path.join(workdir, "scene"),
                                      **config["params"])


def program_scene(path: str, device):
    from imbatracer_torch.scene.build import build_scene

    return build_scene(path, quiet=True, device=device)


def reference_inputs(path: str):
    return sceneio.load_scene(path)


def scene_bytes(path: str) -> int:
    """What a traversal of the scene has to read once: each unique
    triangle's three vertices and each instance's two matrices."""
    desc = sceneio.parse_scene_file(path)
    tris = 0
    for mp in desc.mesh_paths:
        obj = sceneio.load_obj(os.path.join(desc.base_dir, mp))
        tris += len(obj.triangles)
    return tris * TRIANGLE_BYTES + len(desc.instances) * INSTANCE_BYTES
