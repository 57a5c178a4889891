"""The frozen roofline arithmetic: the work units the reference counts are
chip_smoke.py's tree_work counts (over the port's plain version's masks)
on small frames, and the bound is chip_smoke's bound_ms."""

from __future__ import annotations

import sys

import pytest

from conftest import ROOT

from benchmark import roofline
from benchmark.reference import tracer

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.mark.parametrize("case", ["config1", "gamma32x24d5"])
def test_counts_are_chip_smokes(case):
    import chip_smoke
    import raytpu_torch as rt
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.scene import LEAF_NAMES, scene_leaves

    if case == "config1":
        scene, cfg = rt.single_sphere_scene(device="cpu"), BENCH_CONFIGS["config1"]
    else:
        scene, cfg = rt.default_scene(device="cpu"), RenderConfig(width=32, height=24)
    want = chip_smoke.tree_work(scene, cfg)
    work = roofline.new_work()
    tracer.render(dict(zip(LEAF_NAMES, scene_leaves(scene))),
                  dict(width=cfg.width, height=cfg.height,
                       alias_factor=cfg.alias_factor, max_depth=cfg.max_depth,
                       zoom=cfg.zoom, image_world_width=cfg.image_world_width,
                       image_world_height=cfg.image_world_height),
                  block_pixels=200, work=work)
    assert work == want
    assert work["node"] > 0 and (case == "config1" or work["spawn"] > 0)
    n_tbl = roofline.table_floats(scene.spheres.count, scene.lights.count)
    for backward in (False, True):
        ms, by, ops, nbytes = chip_smoke.bound_ms(want, n_tbl, cfg.num_pixels, backward)
        s, by2 = roofline.bound_s(work, n_tbl, cfg.num_pixels, backward)
        assert s * 1e3 == pytest.approx(ms, rel=1e-12) and by == by2
        assert roofline.operations(work, backward) == ops


def test_peaks_are_chip_smokes():
    import chip_smoke

    assert (roofline.PEAK_FP32, roofline.PEAK_BYTES) == (chip_smoke.PEAK_FP32,
                                                         chip_smoke.PEAK_BYTES)
