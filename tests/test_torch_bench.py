"""The port's measuring entry points (imbatracer_torch.bench and
imbatracer_torch.tools) against the JAX package's (root bench.py,
tools/run_bench.py), on the CPU at small sizes.  Scenes registered in
either harness's tables go through monkeypatch; the JAX package is
imported and run, never edited.

Tolerances: ray counts within 1% (Russian roulette decisions flip at ulp
level across the two frameworks), image means within 2% relative, the
image metrics equal to 1e-9 on the same arrays."""

import ast
import contextlib
import csv
import functools
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from imbatracer_tpu.frontend import renderer as jrenderer
from imbatracer_tpu.frontend.renderer import RenderSettings as JSettings
from imbatracer_tpu.frontend.renderer import camera_for_scene as jcamera
from imbatracer_tpu.render.integrators.pt import render_pt_frame as jrender
from imbatracer_tpu.scene import procedural as jproc
from imbatracer_tpu.utils import metrics as jmetrics
from imbatracer_torch import bench
from imbatracer_torch.frontend import renderer as trenderer
from imbatracer_torch.io.image import encode_png, load_png
from imbatracer_torch.scene import procedural as tproc
from imbatracer_torch.tools import golden_check, render_golden
from imbatracer_torch.tools import run_bench as rb
from imbatracer_torch.utils import metrics as tmetrics
from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
CORNELL = ("make_cornell_scene", {})
# The smallest two-level scene of tests/test_torch_instancing.py.
SMALL_INSTANCED = ("write_instanced_scene",
                   dict(counts=dict(ground=1, sphere=3, blob=1, crystal=1,
                                    card=6, panel=1)))


def _jax_module(rel, name):
    """A JAX-package script of the repository (not a package module)
    imported from its file."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run_bench():
    return _jax_module("tools/run_bench.py", "jax_run_bench")


@pytest.fixture
def harness(monkeypatch):
    """The port's run_bench with the proc:cornell scene registered and
    the instanced rows on a small generated scene."""
    monkeypatch.setitem(rb.PROC_SCENES, "proc:cornell", CORNELL)
    monkeypatch.setitem(rb.PROC_SCENES, "gen:card", SMALL_INSTANCED)
    return rb


def _golden(path, seed=0):
    """A SIZE x SIZE gradient PNG with noise, the stand-in golden."""
    rs = np.random.RandomState(seed)
    ramp = np.linspace(0.0, 1.0, SIZE, dtype=np.float32)
    img = np.clip(ramp[None, :, None] * np.ones((SIZE, 1, 3), np.float32)
                  + rs.uniform(-0.1, 0.1, (SIZE, SIZE, 3)), 0.0, 1.0)
    with open(path, "wb") as f:
        f.write(encode_png(tmetrics.quantize(img)))
    return str(path)


def _record_images(monkeypatch, cls, store):
    """Keep every image() a ProgressiveRenderer class returns."""
    orig = cls.image

    def image(self):
        out = orig(self)
        store.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "image", image)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_headline_ray_count_matches_jax():
    """(a) The headline's traced rays over frames 1-2 of the procedural
    cornell at 32^2, spp 1, max_len 10 equal the JAX render_pt_frame
    totals on JAX's procedural cornell."""
    size, max_len = 32, 10
    _, d = bench.pt_throughput(size=size, frames=2, device="cpu")
    scene, meta = jproc.make_cornell_scene()
    settings = JSettings(width=size, height=size, spp=1,
                         max_path_len=max_len)
    cam = jcamera(meta, settings)
    want = 0
    for i in (1, 2):
        _, n = jrender(scene, cam, jnp.uint32(i), size, size, spp=1,
                       max_len=max_len, has_masks=meta.has_masks,
                       with_stats=True)
        want += int(n)
    assert d["frames"] == 2 and d["replays"] == 0 and d["reruns"] == 0
    assert d["rays"] == pytest.approx(want, rel=0.01)
    assert d["ms_min"] <= d["ms_median"] <= d["ms_max"]


def _jax_metric_units():
    """{metric: unit} of the dict literals in the JAX bench.py."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [getattr(k, "value", None) for k in node.keys]
            if "metric" in keys and "unit" in keys:
                vals = dict(zip(keys, node.values))
                out[vals["metric"].value] = vals["unit"].value
    return out


def test_bench_output_lines(monkeypatch, tmp_path):
    """(b) The three metrics' names and units are the JAX bench's, the
    secondaries carry its keys, and the last line is {metric, value,
    unit, card} with no vs_baseline."""
    monkeypatch.setattr(bench, "pt_throughput", functools.partial(
        bench.pt_throughput, size=SIZE, frames=1))
    monkeypatch.setattr(bench, "big_scene_metric", functools.partial(
        bench.big_scene_metric, boxes=150, size=SIZE, frames=1))
    monkeypatch.setattr(bench, "still_life_metric", functools.partial(
        bench.still_life_metric, width=SIZE, height=SIZE // 2, frames=1))
    monkeypatch.setattr(bench.procedural, "make_still_life_like",
                        functools.partial(tproc.make_still_life_like,
                                          num_objects=40, num_cards=16))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(["--device", "cpu", "--out-dir",
                           str(tmp_path)]) == 0
    lines = buf.getvalue().strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "card"}
    # 2-decimal Mrays/s, as in JAX: a CPU frame at 16^2 may round to 0.
    assert last["card"] == "cpu" and last["value"] >= 0
    want = _jax_metric_units()
    assert len(want) == 3
    got = {last["metric"]: last["unit"]}
    for name in ("torch_bench_big.json", "torch_bench_1080p.json"):
        with open(tmp_path / name) as f:
            res = json.load(f)
        assert {"metric", "tris", "mode", "value", "unit"} <= set(res)
        assert res["value"] > 0 and res["mode"] == "stream"
        got[res["metric"]] = res["unit"]
    assert got == want
    with open(tmp_path / "torch_bench_headline.json") as f:
        assert json.load(f) == last
    assert "vs_baseline" not in buf.getvalue()


def test_run_one_matches_jax(monkeypatch, tmp_path, harness,
                             jax_run_bench):
    """(c) run_one on the cornell, 2 samples, in both packages: image
    means within 2%, and the port's row metrics equal to the JAX
    metrics on the same arrays."""
    monkeypatch.setitem(jax_run_bench.PROC_SCENES, "proc:cornell", CORNELL)
    golden = _golden(tmp_path / "golden.png")
    extra = {"max_samples": 2}
    jimgs, timgs = [], []
    _record_images(monkeypatch, jrenderer.ProgressiveRenderer, jimgs)
    _record_images(monkeypatch, trenderer.ProgressiveRenderer, timgs)
    jrow = jax_run_bench.run_one("c", "proc:cornell", golden, "pt", SIZE,
                                 SIZE, extra, 600.0)
    trow = rb.run_one("c", "proc:cornell", golden, "pt", SIZE, SIZE, extra,
                      600.0, device="cpu")
    assert trow["samples"] == jrow["samples"] == 2
    assert set(trow) == set(jrow) | {"graph_replays", "graph_reruns"}
    assert trow["graph_replays"] == trow["graph_reruns"] == 0
    ti, ji = timgs[-1], jimgs[-1]
    assert ti.shape == ji.shape == (SIZE, SIZE, 3)
    assert ti.mean() == pytest.approx(ji.mean(), rel=0.02)
    ref = tmetrics.load_reference_png(golden)
    for img in (ti, ji):
        assert tmetrics.rmse(img, ref) == pytest.approx(
            jmetrics.rmse(img, ref), abs=1e-9)
        assert tmetrics.psnr(img, ref) == pytest.approx(
            jmetrics.psnr(img, ref), abs=1e-9)
    assert trow["rmse"] == round(jmetrics.rmse(ti, ref), 5)
    assert trow["psnr"] == round(jmetrics.psnr(ti, ref), 2)


def test_curve_mode_writes_jax_columns(tmp_path, harness):
    """(d) Curve mode with a sample every frame writes the JAX harness's
    columns, one row a frame, each row's PSNR that of its RMSE."""
    golden = _golden(tmp_path / "golden.png")
    curve = tmp_path / "curves" / "curve_c.csv"
    row = rb.run_one("c", "proc:cornell", golden, "pt", SIZE, SIZE,
                     {"max_path_len": 4}, 1.0, curve_path=str(curve),
                     curve_every=0.0, device="cpu")
    with open(os.path.join(ROOT, "results", "curves_r5",
                           "curve_still_life_pt_1080p.csv")) as f:
        jax_header = next(csv.reader(f))
    with open(curve, newline="") as f:
        got = list(csv.reader(f))
    assert got[0] == jax_header == ["time", "frames", "rmse", "psnr"]
    frames = [int(r[1]) for r in got[1:]]
    assert frames == list(range(1, len(frames) + 1)) and frames
    for r in got[1:]:
        assert float(r[3]) == pytest.approx(-20 * np.log10(float(r[2])),
                                            abs=0.02)
    assert row["samples"] == frames[-1] and row["psnr"] != ""


def test_sweep_rows_and_imba_keys(monkeypatch, tmp_path, harness):
    """(e) A spp=1,2 sweep gives a row a value; an IMBA_* key (a JAX
    environment knob) and a non-field raise before any run."""
    monkeypatch.setattr(rb, "PROXY_RUNS", [
        ("tiny_pt", "proc:cornell", "", "pt", SIZE, SIZE,
         {"max_path_len": 3})])
    out = tmp_path / "sweep.csv"
    assert rb.main(["--only", "tiny_pt$", "--sweep", "spp=1,2", "-t", "0.2",
                    "-o", str(out), "--device", "cpu"]) == 0
    rows = _rows(out)
    assert [r["name"] for r in rows] == ["tiny_pt[spp=1]", "tiny_pt[spp=2]"]
    assert all(not r["error"] and int(r["samples"]) > 0 for r in rows)
    assert int(rows[1]["samples"]) % 2 == 0
    for spec in ("IMBA_PT_COMPACT=0,1", "no_such_field=1"):
        with pytest.raises(ValueError):
            rb.main(["--only", "tiny_pt", "--sweep", spec, "-o",
                     str(tmp_path / "x.csv"), "--device", "cpu"])
    assert not (tmp_path / "x.csv").exists()
    assert "IMBA_PT_COMPACT" not in os.environ


def test_selfcheck_instances_passes(tmp_path, harness):
    """(f) The instanced self-check on a small two-level scene: the two-
    level and flattened routes agree, PASS."""
    out = tmp_path / "self.csv"
    assert rb.main(["--selfcheck-instances", "-t", "0.5", "--size",
                    str(SIZE), "-o", str(out), "--device", "cpu"]) == 0
    (row,) = _rows(out)
    assert row["name"] == "instances_selfcheck" and not row["error"]
    assert row["gate"] == "PASS" and int(row["samples"]) > 0


def test_proxy_instanced_row_on_gen_card(monkeypatch, tmp_path, harness):
    """Config 5 renders gen:card, with no golden (its PSNR blank, as for a
    missing golden)."""
    name, scene, golden, algo, _, _, extra = rb.PROXY_RUNS[-1]
    assert (name, scene, golden, algo) == ("instances_vcm_1080p",
                                           "gen:card", "", "vcm")
    monkeypatch.setattr(rb, "PROXY_RUNS", [
        (name, scene, golden, algo, SIZE, SIZE,
         dict(extra, max_path_len=3, light_path_count=64))])
    out = tmp_path / "proxy.csv"
    assert rb.main(["--proxies", "-t", "0.3", "-o", str(out), "--device",
                    "cpu"]) == 0
    (row,) = _rows(out)
    assert row["name"] == name and not row["error"]
    assert int(row["samples"]) > 0 and row["psnr"] == ""


def test_reference_rows_only_with_reference(monkeypatch, tmp_path,
                                            harness, capsys):
    """The reference's rows run only with --reference, their scenes and
    goldens under its test/ directory; without it, and for a scene the
    directory lacks, they print "scene missing" and make no row."""
    from imbatracer_torch.scene.generate import write_instanced_scene

    ref = tmp_path / "reference_test"
    write_instanced_scene(str(ref / "scenes" / "small"),
                          **SMALL_INSTANCED[1])
    monkeypatch.setattr(rb, "DEFAULT_RUNS", [
        ("ref_small", "small/instances.scene", "", "pt", SIZE, SIZE,
         {"max_path_len": 3}),
        ("ref_absent", "small/absent.scene", "ref_absent.png", "pt", SIZE,
         SIZE, {})])
    out = tmp_path / "ref.csv"
    assert rb.main(["-t", "0.2", "-o", str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "skip ref_small: scene missing (no --reference)" in text
    assert not out.exists()
    assert rb.main(["-t", "0.2", "-o", str(out), "--device", "cpu",
                    "--reference", str(ref)]) == 0
    assert "skip ref_absent: scene missing" in capsys.readouterr().out
    (row,) = _rows(out)
    assert row["name"] == "ref_small" and not row["error"]
    assert int(row["samples"]) > 0
    got = rb.reference_runs(str(ref))
    assert got[1][1:3] == (str(ref / "scenes" / "small" / "absent.scene"),
                           str(ref / "references" / "ref_absent.png"))


def test_bench_failed_secondary_sets_rc(monkeypatch, tmp_path):
    """A secondary that fails leaves no file, stale or new, and makes the
    exit code 1; the headline's line still comes last."""
    monkeypatch.setattr(bench, "pt_throughput", functools.partial(
        bench.pt_throughput, size=SIZE, frames=1))

    def broken(device):
        raise RuntimeError("secondary broke")

    monkeypatch.setattr(bench, "big_scene_metric", broken)
    monkeypatch.setattr(bench, "still_life_metric", broken)
    for name in ("torch_bench_big.json", "torch_bench_1080p.json"):
        (tmp_path / name).write_text('{"value": 1.0}')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(["--device", "cpu", "--out-dir",
                           str(tmp_path)]) == 1
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last["metric"] == "pt_megastep_throughput_cornell_1024"
    assert sorted(os.listdir(tmp_path)) == ["torch_bench_headline.json"]


def test_render_golden_writes_under_results(monkeypatch, tmp_path, harness):
    """(g) render_golden at 16^2 with a 0.5 s budget writes its PNG into
    its own directory, never into the tracked goldens/."""
    monkeypatch.setattr(render_golden, "GOLDENS",
                        {"tiny": ("proc:cornell", SIZE, SIZE, 4)})
    monkeypatch.setattr(render_golden, "GOLDEN_DIR",
                        str(tmp_path / "torch_goldens"))
    tracked = os.path.join(ROOT, "goldens")
    before = {n: os.stat(os.path.join(tracked, n)).st_mtime_ns
              for n in os.listdir(tracked)}
    assert render_golden.main(["tiny", "-t", "0.5", "--device", "cpu"]) == 0
    png = tmp_path / "torch_goldens" / "tiny.png"
    assert load_png(str(png)).shape[:2] == (SIZE, SIZE)
    assert {n: os.stat(os.path.join(tracked, n)).st_mtime_ns
            for n in os.listdir(tracked)} == before


def test_golden_check_prints_rmse(tmp_path, capsys):
    """golden_check takes the JAX script's positional arguments and
    prints RMSE / PSNR against the golden."""
    from imbatracer_torch.scene.generate import write_instanced_scene

    scene = write_instanced_scene(str(tmp_path / "scene"))
    golden = _golden(tmp_path / "golden.png")
    out = tmp_path / "render.png"
    assert golden_check.main([scene, golden, "0.3", str(SIZE), "pt",
                              "--device", "cpu", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    line = [ln for ln in text.splitlines() if ln.startswith("RMSE:")][0]
    img = load_png(str(out))[..., :3].astype(np.float32) / 255.0
    ref = tmetrics.load_reference_png(golden)
    assert f"RMSE: {tmetrics.rmse(img, ref):.5f}" in line
    assert "device: cpu" in text
