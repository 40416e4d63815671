"""mitsuba3_experiments_tpu — a differentiable wavefront path tracer in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference repo
``DoeringChristian/mitsuba3-experiments`` (which layers a research integrator
zoo on top of the Mitsuba 3 / Dr.Jit CUDA stack).  Here:

* Dr.Jit's lazily-traced megakernels  -> ``jax.jit``-compiled wavefront programs
  (a ``lax.while_loop``/``scan`` over bounce index with per-lane active masks).
* OptiX/Embree ray tracing            -> flat LBVH arrays traversed by a
  vectorized stack walker (pure XLA).
* DRJIT_STRUCT records                -> registered-dataclass pytrees.
* PCG32 / TEA samplers                -> counter-based uint32 hash RNG.
* drjit.nn coopvec MLP + HashGrid     -> bf16 matmuls + instant-NGP hashing.
* CUDA device parallelism             -> ``jax.sharding.Mesh`` + ``shard_map``
  over the ray/wavefront axis, ``psum`` film + gradient reduction.

Layer map (mirrors SURVEY.md section 7):
  core/        math, warps, RNG, records, distributions    (ref: util.py etc.)
  ops/         prefix-sum / scatter-reduce / compaction    (ref: prefix_sum.py,
               reductions.py, util.py)
  scene/       dict+XML scene compiler, shapes, BVH build  (ref: mitsuba C++)
  intersect/   ray-triangle + BVH traversal                (ref: OptiX/Embree)
  render/      sensors, film, samplers, BSDFs, emitters    (ref: mitsuba C++)
  integrators/ path/MIS, PSSMLT, BDPT, ReSTIR, SPPM, ...   (ref: *.py drivers)
  models/      hash-grid MLPs, nerad, nrc, normflow        (ref: nerad.py ...)
  parallel/    device mesh, sharded render, collectives    (new; no analog)
  utils/       image IO, profiling, config                 (ref: mi.util)
"""

__version__ = "0.1.0"
