"""Rasterizer kernels, and the one place that picks their build per platform.

The kernels in this package are Pallas kernels written for the Triton route.
``interpret_for`` maps the platform a computation runs on to how they run:

  * ``"gpu"``: compiled for the card through Triton;
  * ``"cpu"``: the same kernels in the Pallas interpreter (tests, small
    scenes without a card);
  * anything else: an error. No platform silently falls back to the
    interpreter.

Callers pass the platform explicitly, or leave it to the default backend of
the process (``jax.default_backend()``).
"""

from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")


def interpret_for(platform: str | None = None) -> bool:
    """True if the kernels run in the Pallas interpreter on `platform`."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise ValueError(
        f"no rasterizer kernel for platform {platform!r}; "
        f"supported: {', '.join(PLATFORMS)}")
