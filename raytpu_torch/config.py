"""Render configuration (the counterpart of raytpu.config).

The reference hard-codes its configuration as compile-time constants
(main.cpp:105-108 — W=800, H=600, zoom=-4, aliasFactor=3; the 16x12 world
image plane lives inside the device kernel, raytrace_kernel.cl:910-911).
Here the same knobs are an explicit frozen dataclass consumed by the camera
model, the tracer, the CUDA kernel and the drivers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters.

    Attributes:
      width, height: pixel grid size (reference default 800x600).
      zoom: z component of every camera ray direction (value -4).
      alias_factor: supersampling factor per axis; alias_factor**2 rays per
        pixel (value 3 -> 9 samples).
      max_depth: number of bounce levels below the primary hit.
      image_world_width/height: world-space extent of the image plane (16x12).
      chunk_pixels: pixel-batch size for the eager tracer's chunking — bounds
        peak memory of the 2^depth ray tree; no effect on values.
    """

    width: int = 800
    height: int = 600
    zoom: float = -4.0
    alias_factor: int = 3
    max_depth: int = 5
    image_world_width: float = 16.0
    image_world_height: float = 12.0
    chunk_pixels: int = 8192

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"image size must be positive, got "
                             f"{self.width}x{self.height}")
        if self.alias_factor < 1:
            raise ValueError(f"alias_factor must be >= 1, got {self.alias_factor}")
        if self.max_depth < 0:
            raise ValueError(f"max_depth must be >= 0, got {self.max_depth}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def samples_per_pixel(self) -> int:
        return self.alias_factor * self.alias_factor

    @property
    def rays_per_frame(self) -> int:
        """Camera (primary) rays per frame — the Mrays/s accounting unit."""
        return self.num_pixels * self.samples_per_pixel


# The five benchmark configs from BASELINE.md / BASELINE.json.
BENCH_CONFIGS = {
    "config1": RenderConfig(width=64, height=64, max_depth=0, alias_factor=1),
    "config2": RenderConfig(width=320, height=240, max_depth=2),
    "config3": RenderConfig(width=640, height=480, max_depth=4),
    "config4": RenderConfig(width=160, height=120, max_depth=2),   # gradient-fit task
    "config5": RenderConfig(width=1920, height=1080, max_depth=6),  # 256 spheres
    "golden": RenderConfig(),  # the reference's own 800x600 depth-5 workload
}
