"""Test config: run on a virtual 8-device CPU mesh so sharding logic is
testable without accelerators (SURVEY.md section 4 implication (d)).

JAX_PLATFORMS defaults to cpu; the `gpu`-marked tests run on a card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.  Env vars must be set
before jax is imported anywhere.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# smoke tier: tests measured >=10 s on a CPU host (compile-dominated) are
# auto-marked `slow` here so
#   python -m pytest tests/ -q -m "not slow"
# completes in ~4-5 minutes.  The FULL suite (`-q`, no marker filter) is the
# real gate (~35-40 min on 8 host cores) — the smoke tier trades the heavy
# cross-implementation equality tests for speed, it does not replace them.
_HEAVY = frozenset({
    "test_sharded_replay_grad_matches_single_device",
    "test_replay_grads_sorted_matches_full",
    "test_persistent_sharded_matches_single_device",
    "test_nrc_with_cache_recovers_energy",
    "test_replay_grad_matches_scan_ad",
    "test_record_film_matches_replay_forward",
    "test_pipelined_recorder_matches_record_full",
    "test_replay_grads_trunc_matches_full",
    "test_restir_dynamic_camera",
    "test_path_mis_matches_independent_oracle",
    "test_restir_chunked_frame_matches_whole_frame",
    "test_nerad_training_reduces_residual",
    "test_restir_frames_converge_to_path_reference",
    "test_record_full_matches_record_chunk",
    "test_normflow_rqs_coupling",
    "test_nrc_online_trainer_learns_cache",
    "test_spectral_gray_furnace",
    "test_pipelined_matches_persistent",
    "test_bdpt_beats_path_on_occluded_light",
    "test_pixel_gradients_match_finite_differences",
    "test_bdpt_mis_matches_path_cornell",
    "test_replay_matches_render",
    "test_ptracer_runs_quick",
    "test_sharded_grad_step_allreduce",
    "test_pipelined_engine_stays_busy",
    "test_normflow_roundtrip_and_training",
    "test_emitter_gradient_linearity",
    "test_direct_illumination_matches_independent_oracle",
    "test_differentiable_reflectance_grads",
    "test_sppm_converges_towards_path",
    "test_bdpt_reference_mode_runs_and_matches_scale",
    "test_wavefront_matches_render_bvh",
    "test_sharded_render_matches_single_device",
    "test_chunked_render_identical",
    "test_sharded_render_uneven_wavefront",
    "test_furnace_diffuse",
})


def pytest_collection_modifyitems(config, items):
    for it in items:
        if it.name.split("[")[0] in _HEAVY:
            it.add_marker(pytest.mark.slow)


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process compile-cache memory: the full suite compiles
    hundreds of programs and the XLA CPU compiler has twice segfaulted
    (host-dependent) compiling test_spectral's program at ~48% of the
    suite with every prior module's executables still resident.  Each
    module's tests share compilations; across modules they rarely do."""
    yield
    jax.clear_caches()
