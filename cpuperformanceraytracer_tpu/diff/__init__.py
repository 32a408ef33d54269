"""Differentiable rendering + inverse rendering.

A capability the reference does not have at all (BASELINE.json north
star): pixel gradients w.r.t. sphere/quad geometry, material fields, and
env-map texels flow through the bounce loop. The integrator is written
to be AD-clean (masked selects, stop_gradient on discrete estimator
weights, NaN-safe guards on every sqrt/normalize), so plain
``jax.grad`` of any pixel loss works; parameter gradients psum over the
mesh via shard_map's transpose when the loss is sharded.
"""

from cpuperformanceraytracer_tpu.diff.grad import (  # noqa: F401
    render_for_params,
    image_loss,
    loss_and_grad,
)
from cpuperformanceraytracer_tpu.diff.inverse import (  # noqa: F401
    InverseProblem,
    adam_inverse_render,
)
