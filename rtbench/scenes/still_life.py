"""The still life: the frozen procedural generator's arrays
(`reference/still_life.py`), handed to the program's flat scene build
(`scene/build.assemble_device_scene`, the build the program's own
generator calls) and, unchanged, to the reference."""

from __future__ import annotations

from ..reference import still_life

TRIANGLE_BYTES = 36      # three float32 vertices


def prepare(config: dict, workdir: str):
    return still_life.make_still_life_like(**config["params"])


def program_scene(raw, device):
    from imbatracer_torch.render.envmap import build_envmap
    from imbatracer_torch.scene.build import assemble_device_scene
    from imbatracer_torch.scene.types import SceneMeta

    env = None
    if raw.env_image is not None:
        env = build_envmap(raw.env_image, raw.env_intensity)
    scene, stats = assemble_device_scene(
        raw.v0, raw.v1, raw.v2, raw.attrs, raw.mat_rows, raw.light_rows,
        raw.textures, env, device)
    meta = SceneMeta(
        name="still_life", num_tris=raw.v0.shape[0],
        num_materials=len(raw.mat_rows), num_lights=len(raw.light_rows),
        num_textures=len(raw.textures), has_env=env is not None,
        has_masks=raw.has_masks, has_bump=raw.has_bump,
        cam_pos=raw.cam_pos, cam_dir=raw.cam_dir, cam_up=raw.cam_up,
        bvh_stats=stats)
    return scene, meta


def reference_inputs(raw):
    return raw


def scene_bytes(raw) -> int:
    """The triangles a traversal of the scene has to read once: every
    triangle's three vertices."""
    return raw.v0.shape[0] * TRIANGLE_BYTES
