"""The card's path rules and the wavefront's capacity ladder
(raytpu_torch.render), on the CPU.

  * card_backend and card_train_backend, the "auto" choice of a card
    wherever the scene lies, on raytpu's BASELINE configs, the benchmark's
    three configurations and one scene at each rule's edge: the training
    crossover, K2's shared memory and the dense kernels' depth.
  * The options a render and a training step take: the ladder at
    WF_AUTO_CHUNK, and an explicit capacity_factor without chunk_rays,
    which renders at render_pixels_wavefront's own chunk and trains at
    WF_AUTO_CHUNK.
  * climb_ladder: the rung it ends on, its warnings and its drops.
"""

import inspect
import warnings

import pytest
import torch

import raytpu_torch.grad as tgrad
import raytpu_torch.render as trender
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.scene import (default_scene, random_scene, single_sphere_scene,
                                sphereflake_scene)

torch.set_num_threads(2)

# name -> (the scene from a device, config, "auto"'s render path, its training path)
PATHS = {
    "config1": (single_sphere_scene,
                RenderConfig(width=64, height=64, max_depth=0, alias_factor=1),
                "cuda", "cuda"),
    "config2": (default_scene, RenderConfig(width=320, height=240, max_depth=2),
                "cuda", "cuda"),
    "config3": (default_scene, RenderConfig(width=640, height=480, max_depth=4),
                "cuda", "cuda"),
    "gamma-800x600-d5": (default_scene,
                         RenderConfig(width=800, height=600, max_depth=5,
                                      alias_factor=3),
                         "cuda", "cuda"),
    "rand256-1080p-d6": (lambda device: random_scene(256, num_lights=4, seed=3,
                                                     device=device),
                         RenderConfig(width=1920, height=1080, max_depth=6,
                                      alias_factor=3),
                         "wavefront", "wavefront"),
    "spd-balls4-512-d5": (lambda device: sphereflake_scene(4, device=device),
                          RenderConfig(width=512, height=512, max_depth=5,
                                       alias_factor=3),
                          "wavefront", "wavefront"),
    # N x depth 256 at 640x480 3x3: the pair renders, the wavefront trains.
    "training-crossover": (lambda device: random_scene(64, device=device),
                           RenderConfig(width=640, height=480, max_depth=4),
                           "cuda", "wavefront"),
    # K1 stages 2,500 spheres; K2's tables and gradient table do not fit.
    "k2-shared-memory": (lambda device: random_scene(2500, device=device),
                         RenderConfig(width=64, height=48, max_depth=0,
                                      alias_factor=1),
                         "cuda", "wavefront"),
    "past-max-depth": (default_scene,
                       RenderConfig(width=64, height=48, max_depth=9,
                                    alias_factor=1),
                       "wavefront", "wavefront"),
}


@pytest.mark.parametrize("name", list(PATHS))
def test_the_cards_path_for_render_and_training(name):
    make, cfg, render_path, train_path = PATHS[name]
    scene = make(device="cpu")
    assert trender.card_backend(scene, cfg) == render_path
    assert trender.card_train_backend(scene, cfg) == train_path


def _recording(monkeypatch, module):
    """Patch `module`'s render_pixels_wavefront to record the chunk_rays
    and capacity_factor of each call (the signature's defaults where the
    call names none), and return the list."""
    params = inspect.signature(render_pixels_wavefront).parameters
    seen = []

    def recorder(*args, **kwargs):
        seen.append({k: kwargs.get(k, params[k].default)
                     for k in ("chunk_rays", "capacity_factor")})
        return render_pixels_wavefront(*args, **kwargs)

    monkeypatch.setattr(module, "render_pixels_wavefront", recorder)
    return seen


def test_the_wavefront_options_of_a_render_and_a_training_step(monkeypatch):
    """The ladder's first rung at WF_AUTO_CHUNK for both; an explicit
    capacity_factor without chunk_rays renders at render_pixels_wavefront's
    own chunk (1 << 18) and trains at WF_AUTO_CHUNK (1 << 22)."""
    assert trender.WF_AUTO_CHUNK == 1 << 22
    assert trender.wf_rungs(None) == [
        dict(chunk_rays=1 << 22, capacity_factor=c) for c in trender.WF_AUTO_LADDER]
    assert trender.wf_rungs(dict(capacity_factor=2.0)) == [dict(capacity_factor=2.0)]
    scene = default_scene(device="cpu")
    cfg = RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3)
    rendered = _recording(monkeypatch, trender)
    trained = _recording(monkeypatch, tgrad)
    explicit = dict(capacity_factor=2.0)

    _, info = trender.render_single(scene, cfg, "wavefront", return_info=True)
    assert info["wf_opts"] == dict(chunk_rays=1 << 22, capacity_factor=1.0)
    _, info = trender.render_single(scene, cfg, "wavefront", explicit,
                                    return_info=True)
    assert info["wf_opts"] == explicit
    assert rendered == [dict(chunk_rays=1 << 22, capacity_factor=1.0),
                        dict(chunk_rays=1 << 18, capacity_factor=2.0)]

    tgrad.fit_scene(scene, cfg, target, steps=1, backend="wavefront")
    tgrad.fit_scene(scene, cfg, target, steps=1, backend="wavefront",
                    wf_opts=explicit)
    tgrad.loss_and_grad_sharded(scene, cfg, target, backend="wavefront",
                                wf_opts=explicit)
    tgrad.loss_and_grad_wavefront(scene, cfg, target)
    assert trained == [dict(chunk_rays=1 << 22, capacity_factor=1.0)] + [
        dict(chunk_rays=1 << 22, capacity_factor=2.0)] * 3


RUNGS = [dict(capacity_factor=c) for c in (1.0, 1.25, 2.0)]


# name -> (the rung to start at, each rung's drops, on_drop, the rung it
# ends on, the drops left, the auto-capacity warnings)
CLIMBS = {
    "no-drop": (0, [0, 0, 0], "raise", 0, 0, 0),
    "one-rung-up": (0, [5, 0, 0], "raise", 1, 0, 1),
    "from-the-second-rung": (1, [9, 3, 0], "raise", 2, 0, 1),
    "drops-left-at-the-top": (0, [5, 4, 2], "ignore", 2, 2, 2),
}


@pytest.mark.parametrize("name", list(CLIMBS))
def test_climb_ladder(name):
    start, drops, on_drop, end, left, warned = CLIMBS[name]
    tried = []

    def attempt(rung):
        tried.append(rung)
        return len(tried), drops[RUNGS.index(rung)]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result, n, i = trender.climb_ladder(RUNGS, attempt, start, on_drop)
    assert (i, n) == (end, left) and tried == RUNGS[start:end + 1]
    assert result == len(tried)
    assert sum("auto-capacity" in str(w.message) for w in caught) == warned
    assert len(caught) == warned


def test_climb_ladder_reports_drops_left_at_the_top():
    with pytest.raises(trender.DroppedRaysError, match="dropped 4 live rays"):
        trender.climb_ladder(RUNGS[:1], lambda rung: (None, 4), on_drop="raise")
    with pytest.warns(RuntimeWarning, match="dropped 4 live rays"):
        assert trender.climb_ladder(RUNGS[:1], lambda rung: ("r", 4))[:2] == ("r", 4)
