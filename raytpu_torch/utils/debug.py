"""A render that reports where a NaN or Inf first appears (the counterpart
of raytpu.utils.debug).

raytpu runs its jnp tracer under checkify's float checks.  The port runs
the eager tracer's render_image (raytpu_torch.trace) with an observer
that checks every tensor a level produces; a NaN or Inf is reported by
the level and the field it first appears in, instead of turning up in
pixels later.  The other half of raytpu's module, the Pallas interpreter
as a kernel sanitizer, has its counterparts in the kernels' plain
versions and their g++ host builds (tests/test_torch_*_host.py).
"""

from __future__ import annotations

import dataclasses

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.scene import LEAF_NAMES, scene_leaves
from raytpu_torch.trace import render_image

# The fields of a level's children, in _trace_level's order.
CHILD_FIELDS = ("origin", "direction", "intensity", "matte", "ior", "opacity")


class NonFiniteError(FloatingPointError):
    """A render produced a NaN or Inf."""


@dataclasses.dataclass(frozen=True)
class FloatError:
    """The first non-finite value of a checked render: the bounce `level`
    and the `field` it appeared in; or level None and a scene leaf's name
    as `field` for a non-finite leaf that no level's output shows; or both
    None for a clean render."""
    level: int | None = None
    field: str | None = None

    def get(self) -> str | None:
        """The error's message, or None for a clean render."""
        if self.field is None:
            return None
        if self.level is None:
            return f"non-finite value in scene leaf {self.field}"
        return f"non-finite value in {self.field} at bounce level {self.level}"

    def throw(self):
        """Raise NonFiniteError if the render produced a NaN or Inf."""
        message = self.get()
        if message is not None:
            raise NonFiniteError(message)


def _first_bad(level, named) -> list:
    """[the FloatError of the first non-finite tensor of `named`], or []."""
    for field, t in named:
        if not bool(torch.isfinite(t).all()):
            return [FloatError(level, field)]
    return []


def checked_render(scene, cfg: RenderConfig):
    """Render the full frame with the eager tracer, checking every level's
    emissions and children for NaN and Inf -> (error, image), as
    raytpu.utils.debug.checked_render.  `error.throw()` raises on the first
    non-finite value (level by level: the emission, then the children's
    fields), or else on a non-finite scene leaf whose value reached no
    level's output (a NaN radius makes its sphere vanish); a clean render
    returns an error whose get() is None.  The image is render_image's."""
    first = []

    def check(level, emission, children):
        if not first:
            first.extend(_first_bad(level, zip(
                ("emission",) + tuple(f"children.{f}" for f in CHILD_FIELDS),
                (emission,) + tuple(children or ()))))

    img = render_image(scene, cfg, check)
    first += _first_bad(None, zip(LEAF_NAMES, scene_leaves(scene)))
    return (first[0] if first else FloatError()), img
