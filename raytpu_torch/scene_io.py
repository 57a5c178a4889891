"""Scene (de)serialisation, in raytpu.scene_io's JSON schema:

{
  "spheres": [{"pos": [x,y,z], "radius": r,
               "matte": [r,g,b], "gloss": [r,g,b],      # pre-split values
               "opacity": o, "ior": n}, ...],
  "lights":  [{"pos": [x,y,z], "col": [r,g,b]}, ...],
  "background": {"matte": [r,g,b], "ior": n, "opacity": o}
}

A file saved by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from raytpu_torch.scene import Scene, build_scene


def scene_to_dict(scene: Scene) -> dict:
    sph = scene.spheres.to("cpu")
    lights = scene.lights.to("cpu")
    bg = scene.bg.to("cpu")
    return {
        "spheres": [
            {
                "pos": sph.pos[i].tolist(),
                "radius": float(sph.radius[i]),
                "matte": sph.matte[i].tolist(),
                "gloss": sph.gloss[i].tolist(),
                "opacity": float(sph.opacity[i]),
                "ior": float(sph.ior[i]),
            }
            for i in range(sph.count)
        ],
        "lights": [
            {"pos": lights.pos[i].tolist(), "col": lights.col[i].tolist()}
            for i in range(lights.count)
        ],
        "background": {
            "matte": bg.matte.tolist(),
            "ior": float(bg.ior),
            "opacity": float(bg.opacity),
        },
    }


def scene_from_dict(data: dict, device=None) -> Scene:
    """The Scene a JSON dict describes, on `device` (None: this process's
    card, as build_scene)."""
    sphere_specs = [
        (s["pos"], s["radius"],
         dict(matte=np.asarray(s["matte"], np.float32),
              gloss=np.asarray(s["gloss"], np.float32),
              opacity=np.float32(s["opacity"]),
              ior=np.float32(s["ior"])))
        for s in data["spheres"]
    ]
    light_specs = [(l["pos"], l["col"]) for l in data["lights"]]
    bg = data.get("background", {})
    return build_scene(sphere_specs, light_specs,
                       bg_matte=bg.get("matte", (0.0, 0.0, 0.0)),
                       bg_ior=bg.get("ior", 1.0),
                       bg_opacity=bg.get("opacity", 0.0),
                       device=device)


def save_scene(scene: Scene, path: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene), f, indent=2)


def load_scene(path: str, device=None) -> Scene:
    """The scene of a JSON file, on `device` (None: this process's card, as
    build_scene)."""
    with open(path) as f:
        return scene_from_dict(json.load(f), device=device)
