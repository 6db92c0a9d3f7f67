"""The benchmark's cells cut to a size that a CPU test run holds: the
same code, scene kinds and limits, smaller scenes and images."""

from rtbench import spec

SMALL_PARAMS = {"still_life": dict(num_objects=300, num_cards=40, seed=3),
                "instanced_card": {}}


def small_cell(name: str, width: int = 40, height: int = 24,
               max_len: int = 5, rows: int = 4):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config,
                       params=SMALL_PARAMS[cell.config["scene"]])
    render = dict(cell.traffic["render"], width=width, height=height,
                  max_path_len=max_len)
    if render.get("light_path_count"):
        render["light_path_count"] = width * height // 2
    cell.traffic = dict(cell.traffic, render=render, warmup_frames=1,
                        trace_frames=1,
                        check=dict(cell.traffic["check"], rows=rows))
    return cell
