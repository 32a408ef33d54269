"""Per-ray path-tracing integrator: intersection, material model, bounce loop.

This is the re-derivation of the reference's L2 kernel
(demofox_path_tracing_optimization_v4.cpp:722-910 GetColorForRay,
:575-718 intersection ops) in scalar-per-ray JAX. Control flow is pure
``jnp.where`` masking over a fixed bounce count — the direct analog of
the reference's SIMT-on-SIMD lane masks, minus the ``all_set``
early-outs (a fixed trip count is what XLA wants; every lane always
runs the full pipeline). The Pallas kernel adds the block early-out.

Object intersection is vectorized across the object axis: each per-ray
test evaluates all quads/spheres at once ((N,) arrays) and reduces with
a first-wins argmin — replacing the reference's per-object loop with
masked blends (TestSceneTrace :699-718) by one data-parallel reduction.

Draw-order contract (per bounce iteration, both RNG families, matching
v4's unconditional consumption so oracle == kernel stream-exactly):
  1. env-map jitter: 2 draws iff (env texture and stochastic sampling)
  2. ray-select roll: 1 draw
  3. diffuse unit vector: 3 draws ("normalized3") or 2 ("zangle")
  4. refraction unit vector: same count
  5. roulette roll: 1 draw iff roulette != "off"
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from cpuperformanceraytracer_tpu.core.rng import CounterRng, WangRng
from cpuperformanceraytracer_tpu.core.sampling import (
    random_unit_vector_normalized3,
    random_unit_vector_zangle,
)
from cpuperformanceraytracer_tpu.core.vecmath import (
    Vec3,
    dot3,
    fresnel_reflect_amount,
    reflect,
    refract,
    vec3,
)
from cpuperformanceraytracer_tpu.scene.types import Scene, precompute_quads
from cpuperformanceraytracer_tpu.texture.texture import (
    env_draws_per_bounce,
    sample_environment_deferred,
)

# Kernel constants (demofox_path_tracing_optimization_v4.cpp:8-26)
MIN_RAY_HIT_TIME = 0.01
RAY_POS_NORMAL_NUDGE = 0.01
SUPER_FAR = 10000.0
MIN_RAY_PROBABILITY = 0.001


class MaterialSample(NamedTuple):
    """Per-ray material fields (SMaterialInfo analog, v4 :195-206)."""

    albedo: Vec3
    emissive: Vec3
    specular_chance: jnp.ndarray
    specular_roughness: jnp.ndarray
    specular_color: Vec3
    ior: jnp.ndarray
    refraction_chance: jnp.ndarray
    refraction_roughness: jnp.ndarray
    refraction_color: Vec3


class Hit(NamedTuple):
    """Nearest-hit record (SRayHitInfo analog, v4 :208-215)."""

    dist: jnp.ndarray
    normal: Vec3
    from_inside: jnp.ndarray  # bool
    material_index: jnp.ndarray  # int32


def _safe_normalize(v: Vec3) -> Vec3:
    """Normalize with a clamped denominator: NaN-free for zero vectors
    (the TIR zero-refraction direction, and normal+unit == 0 corner) in
    both the primal and reverse-mode gradients. ``rsqrt`` is what XLA
    makes of ``1/sqrt`` on every backend; writing it out lets the Pallas
    kernel emit the same instruction (kernels/megakernel.py)."""
    return v * lax.rsqrt(jnp.maximum(dot3(v, v), 1e-20))


def _onehot_select(idx: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """table[idx] via one-hot contraction: for tables of <=O(100) entries
    a broadcast-compare-sum fuses into the surrounding elementwise code
    (the replacement for the reference's 17-way _mm256_i32gather_ps
    GatherMaterials, v4 :389-417)."""
    n = table.shape[-1]
    onehot = (jnp.arange(n, dtype=jnp.int32) == idx).astype(table.dtype)
    return jnp.sum(onehot * table, axis=-1)


def fetch_material(scene: Scene, idx: jnp.ndarray) -> MaterialSample:
    m = scene.materials

    def s(t):
        return _onehot_select(idx, t)

    def v(t: Vec3) -> Vec3:
        return Vec3(s(t.x), s(t.y), s(t.z))

    return MaterialSample(
        albedo=v(m.albedo),
        emissive=v(m.emissive),
        specular_chance=s(m.specular_chance),
        specular_roughness=s(m.specular_roughness),
        specular_color=v(m.specular_color),
        ior=s(m.ior),
        refraction_chance=s(m.refraction_chance),
        refraction_roughness=s(m.refraction_roughness),
        refraction_color=v(m.refraction_color),
    )


def _test_quads(scene: Scene, derived, ray_pos: Vec3, ray_dir: Vec3):
    """All quads at once: precomputed-plane hit + dual-edge barycentric
    inside test for both triangles, double-sided via normal flip
    (TestQuadTrace, v4 :575-645). Returns (dist, normal, valid) with
    dist = SUPER_FAR where invalid."""
    q = scene.quads
    n = derived.normal

    ray_offset = q.v0 - ray_pos  # Vec3 of (NQ,)
    denom = dot3(ray_dir, n)
    denom_safe = jnp.where(jnp.abs(denom) < 1e-12,
                           jnp.where(denom < 0, -1e-12, 1e-12), denom)
    dist = dot3(ray_offset, n) / denom_safe
    hit = ray_dir * dist - ray_offset  # hit point relative to V0

    a0 = dot3(hit, derived.nxv01)
    a1 = dot3(hit, derived.nxv20)
    a2 = 1.0 - a0 - a1
    b0 = dot3(hit, derived.nxv30)
    b1 = dot3(hit, derived.nxv02)
    b2 = 1.0 - b0 - b1

    tri1 = (a0 >= 0.0) & (a1 >= 0.0) & (a2 >= 0.0)
    tri2 = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    valid = (tri1 | tri2) & (dist > MIN_RAY_HIT_TIME) & (dist < SUPER_FAR)

    # double-sided: flip the stored normal when the ray hits the back face
    flip = denom > 0.0
    normal = Vec3(
        jnp.where(flip, -n.x, n.x),
        jnp.where(flip, -n.y, n.y),
        jnp.where(flip, -n.z, n.z),
    )
    dist = jnp.where(valid, dist, SUPER_FAR)
    return dist, normal, valid


def _test_spheres(scene: Scene, ray_pos: Vec3, ray_dir: Vec3):
    """All spheres at once: geometric b/c form with from-inside handling
    (TestSphereTrace, v4 :649-695). Returns (dist, normal, from_inside,
    valid)."""
    s = scene.spheres
    m = ray_pos - s.center  # Vec3 of (NS,)
    b = dot3(m, ray_dir)
    c = dot3(m, m) - s.radius * s.radius

    discr = b * b - c
    miss = ((c > 0.0) & (b > 0.0)) | (discr < 0.0)

    # double-where sqrt guard: sqrt'(0) = inf, and the downstream
    # where(valid, ...) only zeroes the cotangent AFTER it has been
    # multiplied by that inf (0 * inf = NaN). Select a safe operand for
    # miss lanes before the sqrt so their gradient path is exactly zero.
    discr_safe = jnp.where(discr > 0.0, discr, 1.0)
    sq = jnp.where(discr > 0.0, jnp.sqrt(discr_safe), 0.0)
    from_inside = -b < sq  # near root behind origin -> we are inside
    dist = jnp.where(from_inside, sq, -sq) - b
    valid = (~miss) & (dist > MIN_RAY_HIT_TIME) & (dist < SUPER_FAR)

    hit_rel = m + ray_dir * dist
    sign = jnp.where(from_inside, -1.0, 1.0)
    normal = _safe_normalize(hit_rel) * sign
    dist = jnp.where(valid, dist, SUPER_FAR)
    return dist, normal, from_inside & valid, valid


def trace_scene(scene: Scene, derived, ray_pos: Vec3, ray_dir: Vec3) -> Hit:
    """Nearest hit over all quads then spheres; first-wins on exact ties,
    matching the reference's strictly-closer blend chain order
    (TestSceneTrace :699-718: quads first, then spheres)."""
    q_dist, q_normal, _q_valid = _test_quads(scene, derived, ray_pos, ray_dir)
    s_dist, s_normal, s_inside, _s_valid = _test_spheres(scene, ray_pos, ray_dir)

    nq = scene.quads.count
    dists = jnp.concatenate([q_dist, s_dist])
    best = jnp.argmin(dists).astype(jnp.int32)
    dist = dists[best]

    normals = Vec3(
        jnp.concatenate([q_normal.x, s_normal.x]),
        jnp.concatenate([q_normal.y, s_normal.y]),
        jnp.concatenate([q_normal.z, s_normal.z]),
    )
    inside = jnp.concatenate([jnp.zeros_like(q_dist, bool), s_inside])
    mats = jnp.concatenate([scene.quads.material, scene.spheres.material])

    normal = Vec3(
        _onehot_select(best, normals.x),
        _onehot_select(best, normals.y),
        _onehot_select(best, normals.z),
    )
    from_inside = _onehot_select(best, inside.astype(jnp.float32)) > 0.5
    mat_idx = _onehot_select(best, mats.astype(jnp.float32)).astype(jnp.int32)
    return Hit(dist=dist, normal=normal, from_inside=from_inside,
               material_index=mat_idx)


def _unit_vector(cfg, rng):
    if cfg.unit_vector_sampler == "zangle":
        return random_unit_vector_zangle(rng)
    return random_unit_vector_normalized3(rng)


def color_for_ray(scene: Scene, derived, texture, cfg, start_pos: Vec3,
                  start_dir: Vec3, rng):
    """The bounce loop (GetColorForRay, v4 :722-910), fixed trip count
    ``cfg.bounces + 1`` with per-lane alive masking.

    Differences from the reference, all deliberate and flag-gated:
      - no reciprocal or exp approximations beyond the compiler's own;
      - roulette termination configurable: the reference v4 boosts
        survivors WITHOUT terminating (:890-900) — its "v4_quirk" mode
        here; "terminate" implements the correct v3-scalar semantics.
    Returns (color Vec3, rng).
    """
    env_draws = env_draws_per_bounce(texture, cfg)

    def bounce_body(_, carry):
        ret, throughput, pos, dir, alive, miss_state, rng = carry
        hit = trace_scene(scene, derived, pos, dir)

        # env jitter draws are consumed every iteration (stream contract,
        # mirroring v4's unconditional per-bounce env sampling :745-779) —
        # but the LOOKUP is deferred: a path consumes env radiance at most
        # once (at its first miss, after which it is dead), so the gather
        # happens once per path after the loop, not once per bounce.
        if env_draws:
            jr, rng = rng.next01()
            jc, rng = rng.next01()
        else:
            jr = jc = jnp.float32(0.0)

        miss = hit.dist >= SUPER_FAR
        first_miss = alive & miss
        update = alive & ~miss

        miss_dir, miss_thr, miss_jr, miss_jc, missed = miss_state

        def cap(new, old):
            return jnp.where(first_miss, new, old)

        miss_state = (
            Vec3(cap(dir.x, miss_dir.x), cap(dir.y, miss_dir.y),
                 cap(dir.z, miss_dir.z)),
            Vec3(cap(throughput.x, miss_thr.x), cap(throughput.y, miss_thr.y),
                 cap(throughput.z, miss_thr.z)),
            cap(jr, miss_jr),
            cap(jc, miss_jc),
            missed | first_miss,
        )

        mat = fetch_material(scene, hit.material_index)
        dist = jnp.where(miss, 0.0, hit.dist)  # keep grads/NaNs out of dead lanes

        # Beer's-law absorption through the interior we just exited (v4 :783-787)
        absorb = Vec3(
            jnp.exp(-mat.refraction_color.x * dist),
            jnp.exp(-mat.refraction_color.y * dist),
            jnp.exp(-mat.refraction_color.z * dist),
        )
        new_thr = Vec3(
            jnp.where(hit.from_inside, throughput.x * absorb.x, throughput.x),
            jnp.where(hit.from_inside, throughput.y * absorb.y, throughput.y),
            jnp.where(hit.from_inside, throughput.z * absorb.z, throughput.z),
        )

        # Fresnel-adjusted specular/refraction chances (v4 :789-829)
        spec_chance = mat.specular_chance
        refr_chance = mat.refraction_chance
        has_spec = spec_chance > 0.0
        n1 = jnp.where(hit.from_inside, mat.ior, 1.0)
        n2 = jnp.where(hit.from_inside, 1.0, mat.ior)
        fresnel_spec = fresnel_reflect_amount(
            n1, n2, hit.normal, dir, mat.specular_chance, jnp.float32(1.0)
        )
        chance_mult = (1.0 - fresnel_spec) / jnp.maximum(
            1.0 - mat.specular_chance, 1e-6
        )
        spec_chance = jnp.where(has_spec, fresnel_spec, spec_chance)
        refr_chance = jnp.where(has_spec, refr_chance * chance_mult, refr_chance)

        roll, rng = rng.next01()
        do_spec = (spec_chance > 0.0) & (roll < spec_chance)
        do_refr = (~do_spec) & (refr_chance > 0.0) & (roll < spec_chance + refr_chance)
        do_diff = (~do_spec) & (~do_refr)

        diff_chance = jnp.maximum(1.0 - (spec_chance + refr_chance), 0.0)
        ray_prob = jnp.where(do_spec, spec_chance,
                             jnp.where(do_refr, refr_chance, diff_chance))
        ray_prob = jnp.maximum(ray_prob, MIN_RAY_PROBABILITY)
        # probability weights are estimator weights, not differentiable
        # physics: detach so where-grads stay unbiased
        ray_prob = lax.stop_gradient(ray_prob)

        # nudge along the normal, flipped for transmission (v4 :831-833)
        nudge_sign = jnp.where(do_refr, -1.0, 1.0)
        new_pos = pos + dir * dist + hit.normal * (RAY_POS_NORMAL_NUDGE * nudge_sign)

        # new direction: cosine-weighted diffuse / glossy reflect / rough
        # refract, selected then normalized once (v4 :836-871)
        unit_d, rng = _unit_vector(cfg, rng)
        diffuse_dir = _safe_normalize(hit.normal + unit_d)

        spec_dir = reflect(dir, hit.normal)
        spec_rough2 = mat.specular_roughness * mat.specular_roughness
        spec_dir = spec_dir + (diffuse_dir - spec_dir) * spec_rough2

        eta = jnp.where(hit.from_inside, mat.ior, 1.0 / mat.ior)
        refr_dir = refract(dir, hit.normal, eta)
        unit_r, rng = _unit_vector(cfg, rng)
        refr_target = _safe_normalize(unit_r - hit.normal)
        refr_rough2 = mat.refraction_roughness * mat.refraction_roughness
        refr_dir = refr_dir + (refr_target - refr_dir) * refr_rough2

        new_dir = Vec3(
            jnp.where(do_spec, spec_dir.x, jnp.where(do_refr, refr_dir.x, diffuse_dir.x)),
            jnp.where(do_spec, spec_dir.y, jnp.where(do_refr, refr_dir.y, diffuse_dir.y)),
            jnp.where(do_spec, spec_dir.z, jnp.where(do_refr, refr_dir.z, diffuse_dir.z)),
        )
        new_dir = _safe_normalize(new_dir)

        # emissive pickup (v4 :873-875)
        new_ret = ret + mat.emissive * new_thr

        # throughput *= albedo-or-specular-color, skipped on refraction
        # (v4 :878-884), then the lottery compensation
        color_factor = Vec3(
            jnp.where(do_spec, mat.specular_color.x, mat.albedo.x),
            jnp.where(do_spec, mat.specular_color.y, mat.albedo.y),
            jnp.where(do_spec, mat.specular_color.z, mat.albedo.z),
        )
        new_thr = Vec3(
            jnp.where(do_refr, new_thr.x, new_thr.x * color_factor.x),
            jnp.where(do_refr, new_thr.y, new_thr.y * color_factor.y),
            jnp.where(do_refr, new_thr.z, new_thr.z * color_factor.z),
        )
        new_thr = new_thr * (1.0 / ray_prob)

        # Russian roulette (v4 :890-900 / v3-scalar semantics)
        if cfg.roulette != "off":
            p = jnp.clip(new_thr.max_component(), 0.0, 1.0)
            rr, rng = rng.next01()
            terminated = rr > p
            boost = 1.0 / lax.stop_gradient(jnp.maximum(p, MIN_RAY_PROBABILITY))
            new_thr = Vec3(
                jnp.where(terminated, new_thr.x, new_thr.x * boost),
                jnp.where(terminated, new_thr.y, new_thr.y * boost),
                jnp.where(terminated, new_thr.z, new_thr.z * boost),
            )
            if cfg.roulette == "terminate":
                update = update & ~terminated

        # masked writeback of persistent state (v4 :902-906)
        def w3(new: Vec3, old: Vec3) -> Vec3:
            return Vec3(
                jnp.where(update, new.x, old.x),
                jnp.where(update, new.y, old.y),
                jnp.where(update, new.z, old.z),
            )

        ret = w3(new_ret, ret)
        throughput = w3(new_thr, throughput)
        pos = w3(new_pos, pos)
        dir = w3(new_dir, dir)
        return (ret, throughput, pos, dir, update, miss_state, rng)

    miss_state0 = (vec3(0.0, 0.0, 1.0), vec3(0.0), jnp.float32(0.0),
                   jnp.float32(0.0), jnp.bool_(False))
    carry = (vec3(0.0), vec3(1.0), start_pos, start_dir, jnp.bool_(True),
             miss_state0, rng)
    n_segments = cfg.bounces + 1
    body = bounce_body
    if getattr(cfg, "remat_bounces", False):
        # path-replay backward: store only each segment's input carry and
        # replay the segment during the backward sweep (SURVEY.md 7.7) —
        # rematerialization of the bounce body is exactly that strategy
        import jax as _jax

        body = _jax.checkpoint(bounce_body, static_argnums=())
    if getattr(cfg, "unroll_bounces", False):
        for i in range(n_segments):
            carry = body(i, carry)
    else:
        # rolled loop: keeps the traced graph one-bounce-sized, which is
        # what keeps XLA compile time sane at 8 bounces x high spp
        carry = lax.fori_loop(0, n_segments, body, carry)
    ret, _, _, _, _, miss_state, rng = carry

    # deferred env lookup: ONE texel gather per path (vs one per bounce) —
    # identical values, since only the first-miss bounce's jitter/dir/
    # throughput ever reached the output
    miss_dir, miss_thr, miss_jr, miss_jc, missed = miss_state
    env = sample_environment_deferred(texture, miss_dir, cfg, miss_jr, miss_jc)
    ret = Vec3(
        jnp.where(missed, ret.x + env.x * miss_thr.x, ret.x),
        jnp.where(missed, ret.y + env.y * miss_thr.y, ret.y),
        jnp.where(missed, ret.z + env.z * miss_thr.z, ret.z),
    )
    return ret, rng


def camera_ray(camera, x, y, width, height, rng, jitter: bool):
    """Primary ray for fragCoord (x, y) (mainImage, v4 :1092-1122):
    sub-pixel jitter in [-.5, .5)^2, NDC target on the z = +-distance
    plane, aspect correction dividing y by W/H. Consumes 2 draws iff
    ``jitter``. Returns (origin, dir, rng)."""
    if jitter:
        jx, rng = rng.next01()
        jy, rng = rng.next01()
        fx = x + (jx - 0.5)
        fy = y + (jy - 0.5)
    else:
        fx, fy = x, y
    u = (fx / width) * 2.0 - 1.0
    v = (fy / height) * 2.0 - 1.0
    v = v * (height / width)  # rayTarget.y /= aspect
    target = Vec3(u, v, camera.forward_z * camera.distance)
    direction = _safe_normalize(target)
    return camera.position, direction, rng


def render_pixel(scene: Scene, camera, texture, cfg, x, y, frame,
                 spp_offset=0, spp_count=None):
    """One pixel, ``spp_count`` (default cfg.spp) samples averaged
    (mainImage spp loop, v4 :1125-1129). x/y are float fragCoords; frame
    is the accumulation index (also the RNG epoch).

    wang RNG: one sequential stream per (pixel, frame) shared by jitter
    and all samples, exactly like the reference. counter RNG: one
    addressable stream per (pixel, frame, sample) — jitter then re-drawn
    per sample, which is what makes the sample axis shardable:
    ``spp_offset`` names this shard's first sample index (parallel/shard.py
    passes axis_index * spp_local).
    """
    if spp_count is None:
        spp_count = cfg.spp
    xi = x.astype(jnp.uint32) if hasattr(x, "astype") else jnp.uint32(x)
    yi = y.astype(jnp.uint32) if hasattr(y, "astype") else jnp.uint32(y)
    derived = precompute_quads(scene.quads)

    color = vec3(0.0)
    if cfg.rng == "wang":
        rng = WangRng.from_pixel(xi, yi, frame)
        origin, direction, rng = camera_ray(
            camera, x, y, cfg.width, cfg.height, rng, cfg.jitter
        )

        def wang_sample(carry, _):
            acc, rng = carry
            c, rng = color_for_ray(scene, derived, texture, cfg, origin,
                                   direction, rng)
            return (acc + c * (1.0 / spp_count), rng), None

        (color, rng), _ = lax.scan(
            wang_sample, (color, rng), None, length=spp_count
        )
    else:
        # counter RNG: every sample is an independent addressable stream,
        # so the spp axis rolls up in a lax.fori_loop (or shards across
        # devices, parallel/shard.py) without sequential-state coupling.
        def sample_body(s, acc):
            rng = CounterRng.from_pixel(xi, yi, frame,
                                        sample=jnp.uint32(spp_offset) + jnp.uint32(s))
            origin, direction, rng = camera_ray(
                camera, x, y, cfg.width, cfg.height, rng, cfg.jitter
            )
            c, _ = color_for_ray(scene, derived, texture, cfg, origin, direction, rng)
            return acc + c

        color = lax.fori_loop(0, spp_count, sample_body, vec3(0.0)) * (
            1.0 / spp_count
        )
    return color
