"""Fused Pallas path-tracing kernel, compiled through Triton.

One program = one (BH, BW) pixel block. The whole per-sample pipeline —
wang-hash or counter RNG, camera ray, the bounce loop with blend-chain
intersection over every quad/sphere, Fresnel material lottery, Beer
absorption, Russian roulette — runs on (BH, BW) f32 blocks held in
registers; the ~25 carried values per pixel never round-trip to device
memory between bounce segments. This is the re-derivation of the
reference's 8-wide SIMD megaloop (GetColorForRay,
demofox_path_tracing_optimization_v4.cpp:722-910) with a pixel block
as the "packet".

The bounce segments run in a rolled ``lax.while_loop`` that stops once
no pixel of the block is alive — the block-level analog of the
reference's all_set(shouldBreak) early-out (v4 :731,781). Per-object
loops are python-unrolled blend chains like TestSceneTrace (:699-718).

Scene data: a concrete scene is baked into the kernel as compile-time
constants (the reference's static InitializeScene data, v4
:1403-1496), which lets the material fetch collapse to distinct-value
selects and drops shading paths the scene cannot exercise. A traced
scene is read as scalars from small (N, K) f32 tables in device memory.

Environment radiance is DEFERRED: each path needs at most one env-map
texel (its first miss kills it), so the kernel emits (miss_dir,
miss_throughput, jitter) planes and the env gather + final add run
outside in XLA. RNG draw order matches the oracle exactly
(render/integrator.py draw-order contract).

Interpret mode: ``lax.platform_dependent`` picks the Pallas interpreter
only where the computation is lowered for the CPU platform (the tests);
lowered for CUDA, the kernel compiles through Triton or the program
fails.

Numerics: kernel and oracle are written with the same ops and are kept
to Triton's and XLA's own lowering of them: ``sqrt``/``exp`` are
libdevice calls in both, and normalization uses ``rsqrt`` — what XLA's
algebraic simplifier makes of ``1/sqrt`` anyway (render/integrator.py
``_safe_normalize``). Forcing IEEE ``div.rn.f32`` in the kernel was
measured to agree worse with XLA than Triton's own division; with the
ops as they are, kernel and un-jitted oracle agree bit for bit on an
H100 at 1280x720 (PERF.md).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.rng import counter_rand01, rand01
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
)
from cpuperformanceraytracer_tpu.render.integrator import (
    MIN_RAY_HIT_TIME,
    MIN_RAY_PROBABILITY,
    RAY_POS_NORMAL_NUDGE,
    SUPER_FAR,
)
from cpuperformanceraytracer_tpu.scene.types import Scene, precompute_quads
from cpuperformanceraytracer_tpu.texture.texture import sample_environment_deferred

# Pixels each thread holds: num_warps = block pixels / (32 * this). Each
# pixel carries ~25 f32 values plus temporaries; one pixel per thread was
# fastest on an H100 (2 within noise, 4 slower by ~30%; PERF.md).
PIXELS_PER_THREAD = 1


def _safe_normalize(v: Vec3) -> Vec3:
    # the oracle's _safe_normalize, op for op
    return v * lax.rsqrt(jnp.maximum(dot3(v, v), 1e-20))


def _w3(cond, new: Vec3, old: Vec3) -> Vec3:
    if cond is True:
        return new
    if cond is False:
        return old
    return Vec3(
        jnp.where(cond, new.x, old.x),
        jnp.where(cond, new.y, old.y),
        jnp.where(cond, new.z, old.z),
    )


def _wh(cond, a, b):
    """jnp.where with python-bool shortcut (baked-scene specialization)."""
    if cond is True:
        return a
    if cond is False:
        return b
    return jnp.where(cond, a, b)


# ----------------------------------------------------------------------------
# Scene packing: pytrees -> flat f32 tables
# ----------------------------------------------------------------------------

QUAD_COLS = 25  # v0(3) n(3) nxv01/12/20/02/23/30 (18) mat(1)
SPH_COLS = 5    # center(3) radius(1) mat(1)
MAT_COLS = 17   # SMaterialInfo fields in SoA order (v4 :330-349)


def pack_scene(scene: Scene):
    d = precompute_quads(scene.quads)
    q = scene.quads

    def cat3(v):
        return [v.x, v.y, v.z]

    quad_tbl = jnp.stack(
        cat3(q.v0) + cat3(d.normal) + cat3(d.nxv01) + cat3(d.nxv12)
        + cat3(d.nxv20) + cat3(d.nxv02) + cat3(d.nxv23) + cat3(d.nxv30)
        + [q.material.astype(jnp.float32)],
        axis=-1,
    )  # (NQ, 25)
    s = scene.spheres
    sph_tbl = jnp.stack(
        cat3(s.center) + [s.radius, s.material.astype(jnp.float32)], axis=-1
    )  # (NS, 5)
    m = scene.materials
    mat_tbl = jnp.stack(
        cat3(m.albedo) + cat3(m.emissive)
        + [m.specular_chance, m.specular_roughness]
        + cat3(m.specular_color)
        + [m.ior, m.refraction_chance, m.refraction_roughness]
        + cat3(m.refraction_color),
        axis=-1,
    )  # (NM, 17)
    return quad_tbl, sph_tbl, mat_tbl


def pack_camera(camera, cfg) -> "jnp.ndarray":
    """(8,) camera table: position(3), distance, forward_z, ambient(3).
    The ambient rides in the camera table because the kernel adds it
    inline on first miss when env_mode == 'none'."""
    a = cfg.ambient
    return jnp.stack([
        camera.position.x, camera.position.y, camera.position.z,
        camera.distance, camera.forward_z,
        jnp.float32(a[0]), jnp.float32(a[1]), jnp.float32(a[2]),
    ])


class _BlockWangRng:
    """WangRng-compatible draw API over a (BH, BW) u32 state block."""

    def __init__(self, state):
        self.state = state

    def next01(self):
        v, s = rand01(self.state)
        return v, _BlockWangRng(s)

    def carry(self):
        return self.state


class _BlockCtrRng:
    """CounterRng-compatible draw API over (BH, BW) key blocks. Only the
    draw counter is loop-carried; the keys are invariant."""

    def __init__(self, key0, key1, ctr):
        self.key0, self.key1, self.ctr = key0, key1, ctr

    def next01(self):
        v = counter_rand01(self.key0, self.key1, self.ctr, 0)
        return v, _BlockCtrRng(self.key0, self.key1, self.ctr + 1)

    def carry(self):
        return self.ctr


def _const(x):
    """Python-float compile-time constant, or None if traced."""
    return float(x) if isinstance(x, (int, float)) else None


def _is_const(x, value=None):
    c = _const(x)
    return c is not None and (value is None or c == value)


# ----------------------------------------------------------------------------
# Kernel body
# ----------------------------------------------------------------------------


def _make_kernel(cfg: RenderConfig, nq: int, ns: int, nm: int,
                 bh: int, bw: int, baked=None):
    """Build the kernel body for static (cfg, scene sizes, block shape).

    ``baked``: optional (quad_np, sph_np, mat_np, cam_np) numpy tables —
    the scene as compile-time constants. None = every table cell is read
    from the (traced) table inputs.

    The scalar input carries [frame, row0, sample0]: row0 = this
    shard's first global pixel row; sample0 = the first counter-RNG
    sample index of this invocation's spp loop (streams are addressable
    per (pixel, frame, sample), so env frames split into per-sample
    dispatches and spp shards offset their sample window).
    """
    height, width = cfg.height, cfg.width
    env_out = cfg.env_mode != "none"
    env_draws = env_out and cfg.env_sampling == "stochastic"
    unit_vec = (random_unit_vector_zangle
                if cfg.unit_vector_sampler == "zangle"
                else random_unit_vector_normalized3)

    def cell(ref, table, row, col):
        return ref[row, col] if baked is None else float(baked[table][row, col])

    def vec(ref, table, row, col0):
        return Vec3(*(cell(ref, table, row, col0 + i) for i in range(3)))

    def load_quads(quad_ref):
        """Every per-quad scalar, read once per program (not per bounce)."""
        return [(
            vec(quad_ref, 0, qi, 0),    # v0
            vec(quad_ref, 0, qi, 3),    # n
            vec(quad_ref, 0, qi, 6),    # nxv01
            vec(quad_ref, 0, qi, 12),   # nxv20
            vec(quad_ref, 0, qi, 15),   # nxv02
            vec(quad_ref, 0, qi, 21),   # nxv30
            cell(quad_ref, 0, qi, 24),  # material index (f32)
        ) for qi in range(nq)]

    def load_spheres(sph_ref):
        return [(vec(sph_ref, 1, si, 0), cell(sph_ref, 1, si, 3),
                 cell(sph_ref, 1, si, 4)) for si in range(ns)]

    def load_materials(mat_ref):
        return [[cell(mat_ref, 2, mi, k) for k in range(MAT_COLS)]
                for mi in range(nm)]

    def load_camera(cam_ref):
        return [cam_ref[i] if baked is None else float(baked[3][i])
                for i in range(8)]

    def trace(quads, spheres, pos: Vec3, dir: Vec3):
        """Blend-chain nearest hit over all objects (TestSceneTrace
        analog): returns (dist, normal, from_inside, mat_idx_f32)."""
        best = jnp.full((bh, bw), SUPER_FAR, jnp.float32)
        normal = Vec3(jnp.zeros((bh, bw)), jnp.zeros((bh, bw)),
                      jnp.ones((bh, bw)))
        inside = jnp.zeros((bh, bw), jnp.bool_)
        mat = jnp.zeros((bh, bw), jnp.float32)

        for v0, n, nxv01, nxv20, nxv02, nxv30, mq in quads:
            ray_off = Vec3(v0.x - pos.x, v0.y - pos.y, v0.z - pos.z)
            denom = dot3(dir, n)
            denom = jnp.where(jnp.abs(denom) < 1e-12,
                              jnp.where(denom < 0, -1e-12, 1e-12), denom)
            dist = dot3(ray_off, n) / denom
            hitp = dir * dist - ray_off
            a0 = dot3(hitp, nxv01)
            a1 = dot3(hitp, nxv20)
            b0 = dot3(hitp, nxv30)
            b1 = dot3(hitp, nxv02)
            tri1 = (a0 >= 0.0) & (a1 >= 0.0) & (1.0 - a0 - a1 >= 0.0)
            tri2 = (b0 >= 0.0) & (b1 >= 0.0) & (1.0 - b0 - b1 >= 0.0)
            valid = (tri1 | tri2) & (dist > MIN_RAY_HIT_TIME) & (dist < best)

            flip = dot3(dir, n) > 0.0
            qn = Vec3(jnp.where(flip, -n.x, n.x), jnp.where(flip, -n.y, n.y),
                      jnp.where(flip, -n.z, n.z))
            best = jnp.where(valid, dist, best)
            normal = _w3(valid, qn, normal)
            # (quads never report from-inside, and they run before every
            # sphere, so no ``inside`` update is needed here)
            mat = jnp.where(valid, mq, mat)

        for c, r, ms in spheres:
            m_ = Vec3(pos.x - c.x, pos.y - c.y, pos.z - c.z)
            b = dot3(m_, dir)
            cc = dot3(m_, m_) - r * r
            discr = b * b - cc
            miss = ((cc > 0.0) & (b > 0.0)) | (discr < 0.0)
            # double-where sqrt guard, as the oracle's _test_spheres
            discr_safe = jnp.where(discr > 0.0, discr, 1.0)
            sq = jnp.where(discr > 0.0, jnp.sqrt(discr_safe), 0.0)
            from_in = -b < sq
            dist = jnp.where(from_in, sq, -sq) - b
            valid = (~miss) & (dist > MIN_RAY_HIT_TIME) & (dist < best)
            hit_rel = m_ + dir * dist
            sn = _safe_normalize(hit_rel) * jnp.where(from_in, -1.0, 1.0)
            best = jnp.where(valid, dist, best)
            normal = _w3(valid, sn, normal)
            inside = (valid & from_in) | (~valid & inside)
            mat = jnp.where(valid, ms, mat)

        return best, normal, inside, mat

    def fetch_material(materials, idx):
        """17-field material fetch (GatherMaterials analog, v4 :389-417),
        per field:

        Constant field (every material's value is a python float — a
        baked scene): DISTINCT-VALUE grouping — (#distinct values - 1)
        selects against precomputed union masks, and a scene-wide
        constant field becomes a python float (letting downstream
        shading code drop out at trace time).

        Traced field: broadcast-compare-select chain over NM materials
        (shared eq masks across fields)."""
        eq = {}

        def eq_mask(mi):
            if mi not in eq:
                eq[mi] = idx == float(mi)
            return eq[mi]

        union_cache = {}

        def union_mask(mis):
            key = frozenset(mis)
            if key not in union_cache:
                m = eq_mask(mis[0])
                for mi in mis[1:]:
                    m = m | eq_mask(mi)
                union_cache[key] = m
            return union_cache[key]

        fields = []
        for k in range(MAT_COLS):
            vals = [materials[mi][k] for mi in range(nm)]
            if not all(isinstance(v, (int, float)) for v in vals):
                field = jnp.zeros((bh, bw), jnp.float32)
                for mi in range(nm):
                    field = jnp.where(eq_mask(mi), vals[mi], field)
                fields.append(field)
                continue
            groups = {}
            for mi in range(nm):
                groups.setdefault(vals[mi], []).append(mi)
            if len(groups) == 1:
                fields.append(next(iter(groups)))  # python float constant
                continue
            # the most common value is the base (selected by default)
            base = max(groups.items(), key=lambda kv: len(kv[1]))[0]
            field = jnp.full((bh, bw), base, jnp.float32)
            for v, mis in groups.items():
                if v != base:
                    field = jnp.where(union_mask(mis), v, field)
            fields.append(field)
        return fields

    def make_camera_ray(cam):
        def camera_ray_blk(rng_carry, rng_keys, frag_x, frag_y):
            """Primary ray for the block (mainImage analog): jitter
            draws + NDC target + normalize. Once per frame in wang mode
            (the reference draws jitter ONCE and shares the ray across
            the spp loop, v4 :1109-1129); per sample in counter mode."""
            rng = make_rng(rng_keys, rng_carry)
            if cfg.jitter:
                jx, rng = rng.next01()
                jy, rng = rng.next01()
                fx = frag_x + (jx - 0.5)
                fy = frag_y + (jy - 0.5)
            else:
                fx, fy = frag_x, frag_y
            u = (fx / width) * 2.0 - 1.0
            v = (fy / height) * 2.0 - 1.0
            v = v * (height / width)
            cam_pos = Vec3(*(jnp.full((bh, bw), cam[i]) for i in range(3)))
            target = Vec3(u, v, jnp.full((bh, bw), cam[4] * cam[3]))
            return cam_pos, _safe_normalize(target), rng.carry()

        return camera_ray_blk

    def make_rng(keys, carry):
        if cfg.rng == "wang":
            return _BlockWangRng(carry)
        return _BlockCtrRng(keys[0], keys[1], carry)

    def make_bounce_body(quads, spheres, materials, cam):
        """The per-segment bounce body over explicit scene values (lists
        of traced scalars or baked python floats). Estimator weights
        (lottery inverse-probability, roulette boost) are detached
        exactly like the oracle integrator (render/integrator.py)."""

        def bounce_body(state, rng_keys):
            (ret, thr, pos, dir, alive, miss_dir, miss_thr, miss_jr,
             miss_jc, missed, rng_carry) = state
            rng = make_rng(rng_keys, rng_carry)
            dist, normal, from_inside, mat_idx = trace(quads, spheres,
                                                       pos, dir)
            if env_draws:
                jr, rng = rng.next01()
                jc, rng = rng.next01()
            else:
                jr = jc = jnp.zeros((bh, bw))

            miss = dist >= SUPER_FAR
            first_miss = alive & miss
            update = alive & ~miss

            if not env_out:
                # constant ambient needs no gather: add inline (correct
                # for any spp); cam[5:8] carries the ambient color
                ret = Vec3(
                    jnp.where(first_miss, ret.x + cam[5] * thr.x, ret.x),
                    jnp.where(first_miss, ret.y + cam[6] * thr.y, ret.y),
                    jnp.where(first_miss, ret.z + cam[7] * thr.z, ret.z),
                )
            miss_dir = _w3(first_miss, dir, miss_dir)
            miss_thr = _w3(first_miss, thr, miss_thr)
            miss_jr = jnp.where(first_miss, jr, miss_jr)
            miss_jc = jnp.where(first_miss, jc, miss_jc)
            missed = missed | first_miss

            f = fetch_material(materials, mat_idx)
            (al_r, al_g, al_b, em_r, em_g, em_b, spec_ch, spec_rough,
             sc_r, sc_g, sc_b, ior, refr_ch, refr_rough,
             rc_r, rc_g, rc_b) = f
            albedo = Vec3(al_r, al_g, al_b)
            emissive = Vec3(em_r, em_g, em_b)
            spec_color = Vec3(sc_r, sc_g, sc_b)
            refr_color = Vec3(rc_r, rc_g, rc_b)

            # baked-scene specialization facts (python bools; with a
            # traced scene every one of these is False and the full
            # shading pipeline is emitted)
            no_inside = ns == 0  # quads never report from-inside
            no_beer = no_inside or all(
                _is_const(c, 0.0) for c in (rc_r, rc_g, rc_b))
            never_spec = _is_const(spec_ch, 0.0)
            never_refr = _is_const(refr_ch, 0.0)
            smooth_spec = _is_const(spec_rough, 0.0)
            smooth_refr = _is_const(refr_rough, 0.0)

            d_safe = jnp.where(miss, 0.0, dist)
            from_inside_m = False if no_inside else from_inside

            # Beer absorption
            if no_beer:
                new_thr = thr
            else:
                new_thr = Vec3(
                    jnp.where(from_inside_m, thr.x * jnp.exp(-refr_color.x * d_safe), thr.x),
                    jnp.where(from_inside_m, thr.y * jnp.exp(-refr_color.y * d_safe), thr.y),
                    jnp.where(from_inside_m, thr.z * jnp.exp(-refr_color.z * d_safe), thr.z),
                )

            # Fresnel-adjusted lottery. When NO material has a specular
            # chance the whole Fresnel evaluation (sqrt + div + x^5)
            # drops out — the chances are the raw material fields.
            if never_spec:
                spec_chance = 0.0
                refr_chance = refr_ch
            else:
                has_spec = True if _const(spec_ch) else (spec_ch > 0.0)
                n1 = _wh(from_inside_m, ior, 1.0)
                n2 = _wh(from_inside_m, 1.0, ior)
                fres = fresnel_reflect_amount(n1, n2, normal, dir, spec_ch,
                                              jnp.float32(1.0))
                chance_mult = (1.0 - fres) / jnp.maximum(1.0 - spec_ch, 1e-6)
                spec_chance = _wh(has_spec, fres, spec_ch)
                refr_chance = _wh(has_spec, refr_ch * chance_mult, refr_ch)

            roll, rng = rng.next01()
            do_spec = (False if never_spec
                       else (spec_chance > 0.0) & (roll < spec_chance))
            if never_refr:
                do_refr = False
            else:
                below = roll < spec_chance + refr_chance
                gated = (refr_chance > 0.0) & below
                do_refr = gated if do_spec is False else (~do_spec) & gated

            diff_chance = (
                1.0 if never_spec and never_refr
                else jnp.maximum(1.0 - (spec_chance + refr_chance), 0.0))
            ray_prob = _wh(do_spec, spec_chance,
                           _wh(do_refr, refr_chance, diff_chance))
            if _const(ray_prob) is None:
                inv_prob = 1.0 / jnp.maximum(ray_prob, MIN_RAY_PROBABILITY)
            else:
                inv_prob = 1.0 / max(_const(ray_prob), MIN_RAY_PROBABILITY)

            nudge = _wh(do_refr, -RAY_POS_NORMAL_NUDGE, RAY_POS_NORMAL_NUDGE)
            new_pos = pos + dir * d_safe + normal * nudge

            unit_d, rng = unit_vec(rng)
            diffuse_dir = _safe_normalize(normal + unit_d)
            if never_spec:
                spec_dir = diffuse_dir  # unused (do_spec is False)
            else:
                spec_dir = reflect(dir, normal)
                if not smooth_spec:
                    spec_dir = spec_dir + (diffuse_dir - spec_dir) * (
                        spec_rough * spec_rough)
            # the refraction unit vector is DRAWN unconditionally (RNG
            # stream contract with the oracle) even when its math drops out
            unit_r, rng = unit_vec(rng)
            if never_refr:
                refr_dir = diffuse_dir  # unused (do_refr is False)
            else:
                eta = _wh(from_inside_m, ior, 1.0 / ior)
                refr_dir = refract(dir, normal, eta)
                if not smooth_refr:
                    refr_target = _safe_normalize(unit_r - normal)
                    refr_dir = refr_dir + (refr_target - refr_dir) * (
                        refr_rough * refr_rough)

            new_dir = _w3(do_spec, spec_dir,
                          _w3(do_refr, refr_dir, diffuse_dir))
            new_dir = _safe_normalize(new_dir)

            if all(_is_const(e, 0.0) for e in (em_r, em_g, em_b)):
                new_ret = ret
            else:
                new_ret = ret + emissive * new_thr
            color_factor = _w3(do_spec, spec_color, albedo)
            if do_refr is False:
                new_thr = new_thr * color_factor
            else:
                new_thr = Vec3(
                    jnp.where(do_refr, new_thr.x, new_thr.x * color_factor.x),
                    jnp.where(do_refr, new_thr.y, new_thr.y * color_factor.y),
                    jnp.where(do_refr, new_thr.z, new_thr.z * color_factor.z),
                )
            if _const(inv_prob) != 1.0:
                new_thr = new_thr * inv_prob

            if cfg.roulette != "off":
                p = jnp.clip(
                    jnp.maximum(new_thr.x, jnp.maximum(new_thr.y, new_thr.z)),
                    0.0, 1.0)
                rr, rng = rng.next01()
                terminated = rr > p
                boost = 1.0 / jnp.maximum(p, MIN_RAY_PROBABILITY)
                new_thr = Vec3(
                    jnp.where(terminated, new_thr.x, new_thr.x * boost),
                    jnp.where(terminated, new_thr.y, new_thr.y * boost),
                    jnp.where(terminated, new_thr.z, new_thr.z * boost),
                )
                if cfg.roulette == "terminate":
                    update = update & ~terminated

            ret = _w3(update, new_ret, ret)
            thr = _w3(update, new_thr, thr)
            pos = _w3(update, new_pos, pos)
            dir = _w3(update, new_dir, dir)
            alive = update
            return (ret, thr, pos, dir, alive, miss_dir, miss_thr,
                    miss_jr, miss_jc, missed, rng.carry())

        return bounce_body

    def sample_once(bounce_body, rng_keys, rng_carry, pos, dir, allow_exit):
        """One path-trace sample from a prepared primary ray: returns
        (ret, miss_state, rng_carry).

        The bounce segments run in a rolled while loop. ``allow_exit``
        (python or traced bool) ends the loop once every pixel of the
        block is dead. Skipping a segment also skips its RNG draws, so
        exiting is only legal when no later sample continues the same
        sequential stream (counter RNG always; wang RNG's last sample)."""
        zeros = jnp.zeros((bh, bw))
        state = (Vec3(zeros, zeros, zeros), Vec3(*(jnp.ones((bh, bw)),) * 3),
                 pos, dir, jnp.ones((bh, bw), jnp.bool_),
                 Vec3(zeros, zeros, jnp.ones((bh, bw))),
                 Vec3(zeros, zeros, zeros), zeros, zeros,
                 jnp.zeros((bh, bw), jnp.bool_), rng_carry)
        n_segments = cfg.bounces + 1

        def cond(c):
            seg, state = c
            more = seg < n_segments
            if allow_exit is False:
                return more
            any_alive = jnp.max(jnp.where(state[4], 1.0, 0.0)) > 0.0
            if allow_exit is True:
                return more & any_alive
            return more & (any_alive | ~allow_exit)

        def body(c):
            seg, state = c
            return seg + 1, bounce_body(state, rng_keys)

        _, state = lax.while_loop(cond, body, (jnp.int32(0), state))
        (ret, _, _, _, _, miss_dir, miss_thr, miss_jr, miss_jc, missed,
         rng_carry) = state
        return ret, (miss_dir, miss_thr, miss_jr, miss_jc, missed), rng_carry

    def kernel(scal_ref, *refs):
        if baked is None:
            quad_ref, sph_ref, mat_ref, cam_ref, *outs = refs
        else:
            quad_ref = sph_ref = mat_ref = cam_ref = None
            outs = refs
        # row0: this shard's first GLOBAL pixel row (0 single-device;
        # axis_index * rows_per_shard under shard_map) — fragCoords and
        # RNG seeds are global-pixel quantities
        row0 = scal_ref[1]
        samp0 = scal_ref[2].astype(jnp.uint32)
        frame_u = scal_ref[0].astype(jnp.uint32)
        row = row0 + pl.program_id(0) * bh + lax.broadcasted_iota(
            jnp.int32, (bh, bw), 0)
        col = pl.program_id(1) * bw + lax.broadcasted_iota(
            jnp.int32, (bh, bw), 1)
        fy_i = (height - 1) - row
        frag_x = col.astype(jnp.float32)
        frag_y = fy_i.astype(jnp.float32)
        fx_u = col.astype(jnp.uint32)
        fy_u = fy_i.astype(jnp.uint32)

        cam = load_camera(cam_ref)
        camera_ray = make_camera_ray(cam)
        bounce_body = make_bounce_body(load_quads(quad_ref),
                                       load_spheres(sph_ref),
                                       load_materials(mat_ref), cam)
        early = cfg.early_exit
        inv_spp = 1.0 / cfg.spp

        if cfg.rng == "wang":
            # python-int literals (not jnp scalars): Pallas kernels may not
            # capture traced constants
            keys = ()
            seed = (fx_u * 1973 + fy_u * 9277 + frame_u * 26699) | 1
            # jitter/ray once per frame, shared by the spp loop (v4 :1109)
            pos, dir, carry = camera_ray(seed, keys, frag_x, frag_y)

            def sample(s, carry, last):
                return sample_once(bounce_body, keys, carry, pos, dir,
                                   early and last)
        else:
            key0 = fx_u * 1973 + fy_u * 9277

            def sample(s, _, last):
                key1 = jnp.broadcast_to(
                    frame_u * 26699
                    + (jnp.asarray(s, jnp.uint32) + samp0) * 40503 + 1,
                    (bh, bw))
                keys = (key0, key1)
                pos, dir, carry = camera_ray(jnp.zeros((bh, bw), jnp.uint32),
                                             keys, frag_x, frag_y)
                return sample_once(bounce_body, keys, carry, pos, dir, early)

            carry = jnp.zeros((bh, bw), jnp.uint32)

        if cfg.spp == 1:
            acc, miss_state, _ = sample(0, carry, True)
        else:
            # env frames split per sample (render_frame_pallas), so a
            # multi-sample dispatch has no miss state to emit
            def spp_body(s, c):
                acc, carry = c
                ret, _, carry = sample(s, carry, s == cfg.spp - 1)
                return acc + ret * inv_spp, carry

            zeros = jnp.zeros((bh, bw))
            acc, _ = lax.fori_loop(0, cfg.spp, spp_body,
                                   (Vec3(zeros, zeros, zeros), carry))

        planes = [acc.x, acc.y, acc.z]
        if env_out:
            miss_dir, miss_thr, miss_jr, miss_jc, _ = miss_state
            planes += [miss_dir.x, miss_dir.y, miss_dir.z,
                       miss_thr.x, miss_thr.y, miss_thr.z, miss_jr, miss_jc]
        for ref, plane in zip(outs, planes):
            ref[...] = plane

    return kernel


def num_warps(bh: int, bw: int, pixels_per_thread: int = 0) -> int:
    """Warps per program for a (bh, bw) block: one thread per
    ``pixels_per_thread`` pixels (default PIXELS_PER_THREAD), clamped to
    Triton's 1..32."""
    ppt = pixels_per_thread or PIXELS_PER_THREAD
    return max(1, min(32, bh * bw // (32 * ppt)))


def padded_extent(height: int, width: int, bh: int, bw: int):
    """(rows, cols) rounded up to whole (bh, bw) blocks: the kernel
    renders the padded frame and the wrapper crops it."""
    return -(-height // bh) * bh, -(-width // bw) * bw


def _pallas_render(scene, camera, cfg: RenderConfig, frame,
                   sample0=0, row0=0, local_height=None):
    """Shared pallas_call setup/dispatch; returns the raw output planes
    (3 color planes, + 8 deferred-env planes when env_mode != 'none').

    ``row0``/``local_height``: render only rows [row0, row0+local_height)
    of the global cfg.height image — the shard_map path passes each
    device's row offset (camera math and RNG seeds stay global-pixel).
    """
    cfg = cfg.validate()
    if cfg.spp > 1 and cfg.env_mode != "none":
        raise NotImplementedError(
            "pallas backend: multi-sample env frames split per sample "
            "(render_frame_pallas handles this for rng='counter')"
        )
    bh, bw = cfg.tile_height, cfg.tile_width
    out_h = cfg.height if local_height is None else local_height
    hp, wp = padded_extent(out_h, cfg.width, bh, bw)

    # bake the scene into the kernel when it is concrete (not traced)
    concrete = not any(isinstance(leaf, jax.core.Tracer)
                       for leaf in jax.tree.leaves((scene, camera)))
    if cfg.bake_scene and concrete:
        with jax.ensure_compile_time_eval():
            tables = pack_scene(scene)
            cam_tbl = pack_camera(camera, cfg)
        baked = tuple(np.asarray(t) for t in (*tables, cam_tbl))
        tables = ()
    else:
        baked = None
        tables = (*pack_scene(scene), pack_camera(camera, cfg))
    # (SceneBuilder pads an empty object family to one inert object, so
    # no table is empty)
    nq, ns = scene.quads.count, scene.spheres.count
    nm = scene.materials.count

    n_out = 3 if cfg.env_mode == "none" else 11
    plane = jax.ShapeDtypeStruct((hp, wp), jnp.float32)
    scalars = jnp.stack([jnp.asarray(frame, jnp.int32).reshape(()),
                         jnp.asarray(row0, jnp.int32).reshape(()),
                         jnp.asarray(sample0, jnp.int32).reshape(())])

    def call(interpret: bool):
        kernel = _make_kernel(cfg, nq, ns, nm, bh, bw, baked=baked)
        return pl.pallas_call(
            kernel,
            grid=(hp // bh, wp // bw),
            in_specs=[pl.BlockSpec()] * (1 + len(tables)),
            out_specs=[pl.BlockSpec((bh, bw), lambda i, j: (i, j))] * n_out,
            out_shape=[plane] * n_out,
            compiler_params=plgpu.CompilerParams(
                num_warps=num_warps(bh, bw),
                num_stages=1),
            backend="triton",
            interpret=interpret,
            name="path_trace_block",
        )

    # the interpreter is chosen by the platform the call is lowered for:
    # only the CPU lowering interprets; on CUDA the kernel compiles
    planes = lax.platform_dependent(
        scalars, *tables, cpu=call(True), cuda=call(False))
    if (hp, wp) != (out_h, cfg.width):
        planes = [p[:out_h, :cfg.width] for p in planes]
    return planes


def render_frame_pallas(scene, camera, texture, cfg: RenderConfig,
                        frame, spp_offset=0, row0=0, local_height=None):
    """Pallas-backed frame render; signature-compatible with
    render_frame. The deferred env gather + final add runs in XLA after
    the kernel.

    spp > 1 with an env map: the deferred miss-state is per sample, so
    the frame splits into one kernel dispatch + env gather PER SAMPLE —
    addressable counter-RNG streams make each sample independent
    (rng="counter" required; the wang stream is sequential across the
    sample loop and cannot split).

    ``spp_offset``/``row0``/``local_height``: sharding hooks — this
    shard's first counter-RNG sample index and its global pixel-row
    window (parallel/shard.py passes axis_index-derived values).
    """
    cfg = cfg.validate()
    # spp_offset may be a traced axis_index under shard_map; only the
    # static case is checkable here (shard.py enforces counter RNG for
    # sharded spp)
    if isinstance(spp_offset, int) and spp_offset and cfg.rng != "counter":
        raise ValueError("spp_offset requires rng='counter'")
    if cfg.spp > 1 and cfg.env_mode != "none":
        if cfg.rng != "counter":
            raise NotImplementedError(
                "pallas backend: spp>1 with an env map needs "
                "rng='counter' (per-sample addressable streams); the "
                "sequential wang stream cannot split across dispatches")
        one = cfg.replace(spp=1)
        acc = None
        for s in range(cfg.spp):
            c = _env_combined(scene, camera, texture, one, frame,
                              sample0=spp_offset + s, row0=row0,
                              local_height=local_height)
            acc = c if acc is None else acc + c
        return acc * (1.0 / cfg.spp)
    return _env_combined(scene, camera, texture, cfg, frame,
                         sample0=spp_offset, row0=row0,
                         local_height=local_height)


def _env_combined(scene, camera, texture, cfg, frame, sample0=0, row0=0,
                  local_height=None):
    """One spp<=1-per-dispatch render + deferred env combine."""
    planes = _pallas_render(scene, camera, cfg, frame, sample0=sample0,
                            row0=row0, local_height=local_height)
    r, g, b = planes[:3]
    if cfg.env_mode == "none":
        # ambient already added in-kernel (constant, no gather needed)
        return Vec3(r, g, b)
    mdx, mdy, mdz, mtx, mty, mtz, jr, jc = planes[3:]
    # a never-missed pixel has miss_throughput == 0, so no mask is
    # needed: env * 0 == 0 (env is finite for the default miss state)
    env = sample_environment_deferred(texture, Vec3(mdx, mdy, mdz), cfg,
                                      jr, jc)
    return Vec3(r + env.x * mtx, g + env.y * mty, b + env.z * mtz)
