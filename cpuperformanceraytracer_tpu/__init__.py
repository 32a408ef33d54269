"""Differentiable path tracer for the demofox scene family, on the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
torgeiba/CPUPerformanceRayTracer (an AVX2 CPU path tracer): branchless
masked intersection kernels, the specular/refraction/diffuse Fresnel
material model, HDR equirect/cubemap environment lighting, progressive
sample accumulation, tonemapping — plus capabilities the reference lacks:
end-to-end differentiability, multi-card sharding over a device mesh,
checkpoint/resume, and a real test pyramid.

Layer map (mirrors SURVEY.md section 1):

    app/       CLI drivers (offline render, bench, inverse render)      [ref L6]
    config     dataclass config + validation                            [ref L5]
    render/    frame orchestration, accumulation, postprocess           [ref L4]
    parallel/  mesh + shard_map sharding (replaces the work queue)      [ref L3]
    kernels/   fused Pallas kernel (Triton route)                       [ref L2]
    scene/     scene/material/camera pytrees + presets                  [ref L1]
    texture/   HDR IO + equirect/cubemap samplers                       [ref L1]
    core/      vec math, RNG, color transforms                          [ref L0]
    diff/      differentiable rendering + inverse rendering             [new]
    io/        image writers, checkpoint/resume                         [new]
    utils/     timing, logging                                          [ref aux]
"""

__version__ = "0.1.0"
