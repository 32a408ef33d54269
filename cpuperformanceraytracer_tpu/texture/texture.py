"""Texture pytree + equirect/cubemap/env sampling.

Re-derivation of texture.{h,cpp}: the reference's
``_mm256_i32gather_ps`` channel gathers become flat-index jnp gathers
(scalar per ray, vectorized by vmap); the branchless max-axis cubemap
face select (texture.cpp:275-404) and the stochastic jittered-nearest
"bilinear" (TexelSampleRandom, texture.cpp:78-86) are reproduced
exactly, draws included, so RNG streams line up with the oracle.

Cubemap layout matches LoadCubemapTexture (asset_loading.cpp:18-44): six
W x H faces stacked vertically into one W x 6H texture, face order
px, nx, py, ny, pz, nz (v offsets 0..5/6).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cpuperformanceraytracer_tpu.core.vecmath import Vec2, Vec3, dot3, lerp, saturate
from cpuperformanceraytracer_tpu.texture.hdr import read_hdr


class Texture(NamedTuple):
    """f32 RGB texture stored as three flat (H*W,) channel planes.

    The SoA planes mirror the reference's channel-base-pointer layout
    (texture.cpp:16-27); ``_gather`` stacks them into one loop-invariant
    (4, H*W) table (hoisted by XLA) and gathers all channels of a texel
    with one query.
    """

    r: jnp.ndarray
    g: jnp.ndarray
    b: jnp.ndarray
    width: int
    height: int


def texture_from_array(rgb) -> Texture:
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    flat = rgb.reshape(-1, 3)
    return Texture(
        r=jnp.asarray(flat[:, 0]),
        g=jnp.asarray(flat[:, 1]),
        b=jnp.asarray(flat[:, 2]),
        width=w,
        height=h,
    )


def load_texture(path: str) -> Texture:
    """LoadTexture analog (asset_loading.cpp:9-16): HDR with vertical flip."""
    return texture_from_array(read_hdr(path, flip_vertical=True))


def load_cubemap_texture(paths) -> Texture:
    """Six faces (px, nx, py, ny, pz, nz) stacked vertically
    (asset_loading.cpp:18-44)."""
    faces = [read_hdr(p, flip_vertical=True) for p in paths]
    h, w, _ = faces[0].shape
    for f in faces:
        if f.shape != (h, w, 3):
            raise ValueError("cubemap faces must share one resolution")
    return texture_from_array(np.concatenate(faces, axis=0))


def _gather(tex: Texture, flat_idx) -> Vec3:
    """One channel-major gather: texel ``flat_idx`` of every channel,
    written as planar (4, *idx.shape) planes (operand (4, N) with the
    channel as the offset dim), so the per-plane slices below are views.
    Under jax.grad its transpose is a scatter-add into the texel planes."""
    tt = jnp.stack(
        [tex.r, tex.g, tex.b, jnp.zeros_like(tex.r)], axis=0)  # (4, N)
    out = jax.lax.gather(
        tt, flat_idx[..., None],
        dimension_numbers=jax.lax.GatherDimensionNumbers(
            offset_dims=(0,), collapsed_slice_dims=(1,),
            start_index_map=(1,)),
        slice_sizes=(4, 1),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    return Vec3(out[0], out[1], out[2])


def texel_fetch(tex: Texture, row, col) -> Vec3:
    """Clamped integer texel fetch (TexelFetch, texture.cpp:6-14)."""
    row = jnp.clip(row, 0, tex.height - 1)
    col = jnp.clip(col, 0, tex.width - 1)
    return _gather(tex, row * tex.width + col)


def sample_nearest(tex: Texture, uv: Vec2) -> Vec3:
    """Truncating nearest fetch at uv*(dim-1)
    (EquirectangularTextureSampleGather inner math, texture.cpp:144-163)."""
    row = (uv.y * (tex.height - 1)).astype(jnp.int32)
    col = (uv.x * (tex.width - 1)).astype(jnp.int32)
    return texel_fetch(tex, row, col)


def sample_bilinear(tex: Texture, uv: Vec2) -> Vec3:
    """Four-tap bilinear (TexelSampleBilinear, texture.cpp:39-76).

    Uses floor/ceil of uv*(dim-1) like the reference (so du/dv come from
    the floor corner and the ceil tap can alias the same texel on exact
    integer coordinates).
    """
    row = uv.y * (tex.height - 1)
    col = uv.x * (tex.width - 1)
    r0 = jnp.floor(row)
    r1 = jnp.ceil(row)
    c0 = jnp.floor(col)
    c1 = jnp.ceil(col)
    dv = row - r0
    du = col - c0

    r0i = r0.astype(jnp.int32)
    r1i = r1.astype(jnp.int32)
    c0i = c0.astype(jnp.int32)
    c1i = c1.astype(jnp.int32)

    c00 = texel_fetch(tex, r0i, c0i)
    c10 = texel_fetch(tex, r0i, c1i)
    c01 = texel_fetch(tex, r1i, c0i)
    c11 = texel_fetch(tex, r1i, c1i)

    top = c00 + (c10 - c00) * du
    bot = c01 + (c11 - c01) * du
    return top + (bot - top) * dv


def stochastic_flat_index(tex: Texture, uv: Vec2, jr, jc):
    """Flat texel index of the stochastic single-tap (jittered nearest,
    TexelSampleRandom, texture.cpp:78-86)."""
    row = uv.y * (tex.height - 1)
    col = uv.x * (tex.width - 1)
    rand_row = jnp.floor(row + jr).astype(jnp.int32)
    rand_col = jnp.floor(col + jc).astype(jnp.int32)
    return rand_row * tex.width + rand_col


def sample_stochastic_with_jitter(tex: Texture, uv: Vec2, jr, jc) -> Vec3:
    """Stochastic single-tap with caller-provided jitter pair in [0,1)^2.

    Split out from :func:`sample_stochastic` so call sites can DRAW the
    jitter inside the bounce loop (keeping the RNG stream contract) but
    defer the actual gather to once per path — each path consumes env
    radiance at most once, at its first miss (see
    render/integrator.py deferred-environment note).
    """
    return _gather(tex, stochastic_flat_index(tex, uv, jr, jc))


def sample_stochastic(tex: Texture, uv: Vec2, rng):
    """Single-tap stochastic bilinear: jittered nearest, 2 draws
    (TexelSampleRandom, texture.cpp:78-86). In expectation this equals
    bilinear filtering, and it is the reference's default env-map path
    (one gather, no neighborhood taps)."""
    jr, rng = rng.next01()
    jc, rng = rng.next01()
    return sample_stochastic_with_jitter(tex, uv, jr, jc), rng


_INV_ATAN = (0.1591, 0.3183)  # (1/2pi, 1/pi), texture.cpp:145


def equirect_uv(direction: Vec3) -> Vec2:
    """Direction -> equirect uv: fract((atan2(z,x), asin(y)) * invAtan + .5)
    then saturate (EquirectangularTextureSampleRandom, texture.cpp:186-203)."""
    u = jnp.arctan2(direction.z, direction.x) * _INV_ATAN[0] + 0.5
    v = jnp.arcsin(jnp.clip(direction.y, -1.0, 1.0)) * _INV_ATAN[1] + 0.5
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    return Vec2(saturate(u), saturate(v))


def cubemap_uv(direction: Vec3) -> Vec2:
    """Branchless max-axis cubemap face select onto the vertical-cross
    stacked texture (CubemapTextureSampleBilinear, texture.cpp:275-339).

    Face priority on ties replicates the reference's blend order:
    X faces, overridden by Y when |y| >= |x|, overridden by Z when
    |z| >= |x| and |z| >= |y|.
    """
    d = direction
    ax, ay, az = jnp.abs(d.x), jnp.abs(d.y), jnp.abs(d.z)

    # X faces
    xgt0 = d.x >= 0.0
    face_u = jnp.where(xgt0, -d.z, d.z)
    face_v = d.y
    v_off = jnp.where(xgt0, 0.0, 1.0 / 6.0)

    # Y faces override when |y| >= |x|
    ygt0 = d.y >= 0.0
    y_u = d.x
    y_v = jnp.where(ygt0, -d.z, d.z)
    y_off = jnp.where(ygt0, 2.0 / 6.0, 3.0 / 6.0)
    ygtx = ay >= ax
    face_u = jnp.where(ygtx, y_u, face_u)
    face_v = jnp.where(ygtx, y_v, face_v)
    v_off = jnp.where(ygtx, y_off, v_off)

    # Z faces override when |z| >= |x| and |z| >= |y|
    zgt0 = d.z >= 0.0
    z_u = jnp.where(zgt0, d.x, -d.x)
    z_v = d.y
    z_off = jnp.where(zgt0, 4.0 / 6.0, 5.0 / 6.0)
    maxz = (az >= ax) & (az >= ay)
    face_u = jnp.where(maxz, z_u, face_u)
    face_v = jnp.where(maxz, z_v, face_v)
    v_off = jnp.where(maxz, z_off, v_off)

    max_abs = jnp.maximum(ax, jnp.maximum(ay, az))
    u = saturate(face_u / max_abs * 0.5 + 0.5)
    v = saturate(face_v / max_abs * 0.5 + 0.5)
    v = saturate(v * (1.0 / 6.0) + v_off)
    return Vec2(u, v)


def sample_equirect(tex: Texture, direction: Vec3, mode: str, rng=None):
    uv = equirect_uv(direction)
    if mode == "stochastic":
        return sample_stochastic(tex, uv, rng)
    if mode == "bilinear":
        return sample_bilinear(tex, uv), rng
    return sample_nearest(tex, uv), rng


def sample_cubemap(tex: Texture, direction: Vec3, mode: str, rng=None):
    uv = cubemap_uv(direction)
    if mode == "stochastic":
        return sample_stochastic(tex, uv, rng)
    if mode == "bilinear":
        return sample_bilinear(tex, uv), rng
    return sample_nearest(tex, uv), rng


def env_draws_per_bounce(tex, cfg) -> int:
    """RNG draws the env path consumes per bounce iteration (the stream
    contract, see integrator draw-order table)."""
    if cfg.env_mode == "none" or tex is None or cfg.env_sampling != "stochastic":
        return 0
    return 2


def sample_environment_deferred(tex, direction: Vec3, cfg, jr, jc) -> Vec3:
    """Miss-radiance lookup with pre-drawn jitter (jr/jc ignored unless
    stochastic). Used by the deferred once-per-path env lookup."""
    if cfg.env_mode == "none" or tex is None:
        a = cfg.ambient
        return Vec3(jnp.float32(a[0]), jnp.float32(a[1]), jnp.float32(a[2]))
    if cfg.env_mode == "equirect":
        d = Vec3(-direction.x, direction.y, -direction.z) if cfg.env_flip_xz else direction
        uv = equirect_uv(d)
    else:
        uv = cubemap_uv(direction)
    if cfg.env_sampling == "stochastic":
        return sample_stochastic_with_jitter(tex, uv, jr, jc)
    if cfg.env_sampling == "bilinear":
        return sample_bilinear(tex, uv)
    return sample_nearest(tex, uv)


def bilinear_resample(rgb: np.ndarray, out_width: int,
                      out_height: int) -> np.ndarray:
    """Pixel-center bilinear resample of an (H, W, 3) image
    (BilinearResampleRGB32 analog, texture.cpp:406-479).

    The reference version is an unused helper whose indexing is buggy
    (row stride ``InWidth-1`` and a transposed output index); this is the
    intended pixel-center semantics — sample at (col+0.5)/out_w scaled
    into source texel space, lerp the 2x2 neighborhood, clamp edge taps.
    """
    src = np.asarray(rgb, np.float32)
    h, w = src.shape[:2]
    u = (np.arange(out_width, dtype=np.float32) + 0.5) / out_width * w - 0.5
    v = (np.arange(out_height, dtype=np.float32) + 0.5) / out_height * h - 0.5
    u0 = np.clip(np.floor(u).astype(np.int64), 0, w - 1)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, h - 1)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    du = np.clip(u - u0, 0.0, 1.0)[None, :, None]
    dv = np.clip(v - v0, 0.0, 1.0)[:, None, None]
    c00 = src[v0[:, None], u0[None, :]]
    c10 = src[v0[:, None], u1[None, :]]
    c01 = src[v1[:, None], u0[None, :]]
    c11 = src[v1[:, None], u1[None, :]]
    top = c00 + (c10 - c00) * du
    bot = c01 + (c11 - c01) * du
    return top + (bot - top) * dv


def sample_environment(tex, direction: Vec3, cfg, rng) -> Tuple[Vec3, object]:
    """Miss-radiance lookup with the v4 conventions.

    env_mode none -> constant ambient (v4 :905 / scalar :307);
    equirect -> optional (-x, y, -z) flip first (v4 :758-759);
    cubemap -> unflipped direction (v4 :747-755).
    Consumes 2 rng draws iff stochastic sampling with a texture —
    call sites rely on this draw-count contract for stream alignment.
    """
    if cfg.env_mode == "none" or tex is None:
        a = cfg.ambient
        return Vec3(jnp.float32(a[0]), jnp.float32(a[1]), jnp.float32(a[2])), rng
    if cfg.env_mode == "equirect":
        d = Vec3(-direction.x, direction.y, -direction.z) if cfg.env_flip_xz else direction
        return sample_equirect(tex, d, cfg.env_sampling, rng)
    return sample_cubemap(tex, direction, cfg.env_sampling, rng)
