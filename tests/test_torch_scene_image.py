"""The port's scene builders, scene conversion, scene files and PPM output
against raytpu's: scenes equal field for field (exactly), JSON files load
across packages, and tone-mapped bytes are identical."""

import dataclasses

import numpy as np
import pytest
import torch

import raytpu.image as jimage
import raytpu.scene as jscene
import raytpu.scene_io as jio
import raytpu_torch.image as timage
import raytpu_torch.scene as tscene
import raytpu_torch.scene_io as tio
from raytpu_torch.scene import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)


def jax_leaves(scene) -> dict:
    """raytpu's Scene pytree leaves as numpy, keyed as scene_from_numpy."""
    return {f"{group}.{f.name}": np.asarray(getattr(getattr(scene, group), f.name))
            for group in ("spheres", "lights", "bg")
            for f in dataclasses.fields(getattr(scene, group))}


def assert_same_leaves(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == np.float32, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


BUILDERS = {
    "default": lambda m: m.default_scene(),
    "default_bg1": lambda m: m.default_scene(1.0),
    "single": lambda m: m.single_sphere_scene(),
    "random256": lambda m: m.random_scene(256, seed=0),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_raytpu_exactly(name):
    build = BUILDERS[name]
    assert_same_leaves(scene_to_numpy(build(tscene)), jax_leaves(build(jscene)))


def test_make_material_matches_raytpu():
    args = (0.3, (0.4, 0.5, 0.7), (0.8, 1.0, 0.7), 0.8, 1.55)
    got, want = tscene.make_material(*args), jscene.make_material(*args)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_scene_from_numpy_round_trips():
    leaves = jax_leaves(jscene.random_scene(16, seed=4))
    scene = scene_from_numpy(leaves)
    assert scene.spheres.count == 16 and scene.lights.count == 4
    assert scene.device.type == "cpu"
    assert_same_leaves(scene_to_numpy(scene), leaves)
    assert_same_leaves(scene_to_numpy(scene.to("cpu")), leaves)


@pytest.mark.parametrize("writer", ["raytpu", "raytpu_torch"])
def test_scene_files_load_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "scene.json")
    want = jax_leaves(jscene.random_scene(8, seed=2, num_lights=3))
    if writer == "raytpu":
        jio.save_scene(jscene.random_scene(8, seed=2, num_lights=3), path)
        got = scene_to_numpy(tio.load_scene(path))
    else:
        tio.save_scene(tscene.random_scene(8, seed=2, num_lights=3), path)
        got = jax_leaves(jio.load_scene(path))
    assert_same_leaves(got, want)


def test_scene_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    jio.save_scene(jscene.default_scene(0.25), a)
    tio.save_scene(tscene.default_scene(0.25), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _images():
    rng = np.random.default_rng(7)
    bright = rng.uniform(0.0, 1.5, (12, 10, 3)).astype(np.float32)  # max > 1
    bright[0, 0, 0] = np.nan
    bright[3, 4, :] = np.nan
    dim = (rng.uniform(0.0, 1.0, (9, 7, 3)) * 1e-4).astype(np.float32)
    dim[1, 1, 1] = np.nan
    return {
        "bright_nan": bright,
        "dim_nan": dim,
        "black": np.zeros((4, 5, 3), np.float32),
        "all_nan": np.full((3, 3, 3), np.nan, np.float32),
    }


@pytest.mark.parametrize("case", sorted(_images()))
def test_tone_map_and_ppm_bytes_match_raytpu(tmp_path, case):
    img = _images()[case]
    assert timage.max_colour_value(img) == jimage.max_colour_value(img)
    np.testing.assert_array_equal(timage.tone_map(img), jimage.tone_map(img))
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    timage.write_ppm(img, a)
    jimage.write_ppm(img, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(timage.read_ppm(b), jimage.read_ppm(a))


def test_write_ppm_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        timage.write_ppm(np.zeros((4, 4), np.float32), str(tmp_path / "x.ppm"))
