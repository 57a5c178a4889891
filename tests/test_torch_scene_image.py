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
from raytpu_torch.parallel import local_device, make_mesh
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
    "default": lambda m, **kw: m.default_scene(**kw),
    "default_bg1": lambda m, **kw: m.default_scene(1.0, **kw),
    "single": lambda m, **kw: m.single_sphere_scene(**kw),
    "random256": lambda m, **kw: m.random_scene(256, seed=0, **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_raytpu_exactly(name):
    build = BUILDERS[name]
    assert_same_leaves(scene_to_numpy(build(tscene, device="cpu")),
                       jax_leaves(build(jscene)))


# Every way to build a scene (or a mesh) without naming a device.
UNNAMED = {
    "default_scene": lambda path: tscene.default_scene(),
    "single_sphere_scene": lambda path: tscene.single_sphere_scene(),
    "random_scene": lambda path: tscene.random_scene(4, seed=1),
    "build_scene": lambda path: tscene.build_scene(
        [((0.0, 0.0, -5.0), 1.0, tscene.make_material(0.0, (1, 1, 1), (0, 0, 0), 1.0, 1.0))],
        [((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))]),
    "scene_from_numpy": lambda path: scene_from_numpy(
        scene_to_numpy(tscene.default_scene(device="cpu"))),
    "load_scene": lambda path: tio.load_scene(path),
    "make_mesh": lambda path: make_mesh(),
    "local_device": lambda path: local_device(),
}


@pytest.fixture
def scene_file(tmp_path):
    path = str(tmp_path / "scene.json")
    tio.save_scene(tscene.default_scene(device="cpu"), path)
    return path


@pytest.mark.parametrize("name", sorted(UNNAMED))
def test_no_device_means_the_card(name, scene_file):
    """Without a device the scene goes to this process's card; without a
    card that raises rather than build on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        UNNAMED[name](scene_file)


def test_device_cpu_builds_on_the_cpu(scene_file):
    for scene in (tscene.default_scene(device="cpu"),
                  tscene.random_scene(4, seed=1, device="cpu"),
                  tio.load_scene(scene_file, device="cpu"),
                  scene_from_numpy(scene_to_numpy(tscene.single_sphere_scene(
                      device="cpu")), device="cpu")):
        assert scene.device.type == "cpu"
    assert make_mesh("cpu").device.type == "cpu"


def test_make_material_matches_raytpu():
    args = (0.3, (0.4, 0.5, 0.7), (0.8, 1.0, 0.7), 0.8, 1.55)
    got, want = tscene.make_material(*args), jscene.make_material(*args)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_scene_from_numpy_round_trips():
    leaves = jax_leaves(jscene.random_scene(16, seed=4))
    scene = scene_from_numpy(leaves, device="cpu")
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
        got = scene_to_numpy(tio.load_scene(path, device="cpu"))
    else:
        tio.save_scene(tscene.random_scene(8, seed=2, num_lights=3, device="cpu"), path)
        got = jax_leaves(jio.load_scene(path))
    assert_same_leaves(got, want)


def test_scene_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    jio.save_scene(jscene.default_scene(0.25), a)
    tio.save_scene(tscene.default_scene(0.25, device="cpu"), b)
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
