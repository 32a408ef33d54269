"""Inverse rendering: recover scene parameters from a target image by
pixel-gradient descent (BASELINE.json config 4).

Adam over a parameter pytree; each step renders with a fresh frame index
(fresh sample set — stochastic gradient descent over the path space) and
follows the L2 pixel gradient. The whole step is one jitted function;
under a mesh-sharded loss the parameter gradients all-reduce
automatically through the shard_map transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import optax

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.diff.grad import image_loss, render_for_params


@dataclasses.dataclass
class InverseProblem:
    scene: object
    camera: object
    texture: object
    cfg: RenderConfig
    target: Vec3


def make_train_step(problem: InverseProblem, optimizer,
                    resample_frames: bool = False) -> Callable:
    """(params, opt_state, step) -> (params, opt_state, loss), jitted.

    resample_frames=False keeps one fixed sample set: the loss is
    deterministic in the params and descent converges fast (correlated
    sampling — the target must be rendered with the same cfg/frame).
    True gives unbiased stochastic gradients over path space at the cost
    of gradient noise (use a lower learning rate / more spp).
    """

    def loss_fn(params, frame):
        img = render_for_params(params, problem.scene, problem.camera,
                                problem.texture, problem.cfg,
                                frame if resample_frames else 0)
        return image_loss(img, problem.target)

    @jax.jit
    def train_step(params, opt_state, step):
        loss, grads = jax.value_and_grad(loss_fn)(params, step)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def make_train_step_k(problem: InverseProblem, optimizer, k: int,
                      resample_frames: bool = False) -> Callable:
    """(params, opt_state, step0) -> (params, opt_state, losses(k,)),
    jitted: K Adam steps fused into ONE device dispatch via lax.scan.

    Host dispatch overhead can exceed a small inverse step's device
    work, so the optimization loop fuses K steps per dispatch like the
    offline renderer fuses K frames (render.frame.make_multi_frame_fn).
    """

    def loss_fn(params, frame):
        img = render_for_params(params, problem.scene, problem.camera,
                                problem.texture, problem.cfg,
                                frame if resample_frames else 0)
        return image_loss(img, problem.target)

    @jax.jit
    def train_step_k(params, opt_state, step0):
        def body(carry, i):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params, step0 + i)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), jnp.arange(k, dtype=jnp.uint32))
        return params, opt_state, losses

    return train_step_k


def adam_inverse_render(
    problem: InverseProblem,
    init_params: Dict,
    steps: int = 200,
    learning_rate: float = 0.01,
    resample_frames: bool = False,
    log_every: int = 0,
    logger=None,
    eps: float = 1e-8,
    steps_per_dispatch: int = 0,
) -> tuple:
    """Run Adam; returns (final_params, losses).

    ``eps`` is Adam's denominator epsilon, usable as a GRADIENT NOISE
    FLOOR: at the default 1e-8, Adam normalizes the ~1e-4 cross-talk
    gradients of barely-observed parameters (a sphere seen only through a
    neighbor's refraction) up to full-size steps, and those coordinates
    random-walk away from the truth. For geometry recovery pass ~1e-2: it
    leaves well-observed gradients (~0.1+) untouched and damps the noise
    walkers ~100x — measured to be the difference between divergence and
    clean recovery on the glass-spheres position problem. Smooth,
    well-observed parameters (albedo/emissive) converge fastest with the
    standard 1e-8.

    ``steps_per_dispatch``: fuse K optimizer steps into one device
    dispatch (0 = auto: the logging cadence when logging, else
    min(steps, 16)). K=1 preserves the original per-step host loop.
    """
    optimizer = optax.adam(learning_rate, eps=eps)
    opt_state = optimizer.init(init_params)

    k = steps_per_dispatch
    if not k:
        k = log_every if (log_every and logger) else min(steps, 16)
    k = max(1, min(k, steps))

    params = init_params
    losses: List[float] = []
    if k == 1:
        train_step = make_train_step(problem, optimizer, resample_frames)
        for i in range(steps):
            params, opt_state, loss = train_step(params, opt_state, i)
            if log_every and logger and i % log_every == 0:
                logger.info("inverse step %d loss %.6f", i, float(loss))
            losses.append(float(loss))
        return params, losses

    train_step_k = make_train_step_k(problem, optimizer, k, resample_frames)
    done = 0
    while done < steps:
        todo = min(k, steps - done)
        step_fn = (train_step_k if todo == k else
                   make_train_step_k(problem, optimizer, todo,
                                     resample_frames))
        params, opt_state, chunk = step_fn(params, opt_state,
                                           jnp.uint32(done))
        if log_every and logger:
            # log the actual boundary step inside this chunk (if any),
            # with ITS loss — matching the per-step path's output
            off = (-done) % log_every
            if off < todo:
                logger.info("inverse step %d loss %.6f", done + off,
                            float(chunk[off]))
        losses.extend(float(x) for x in chunk)
        done += todo
    return params, losses
