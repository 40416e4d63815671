"""validation/checks.py: the correctness checks chip_smoke.py runs on the
GPU.  The CPU tests run them at small sizes; the `gpu` twins run the same
functions at the sizes chip_smoke.py uses and skip without a GPU."""
import pytest

from mitsuba3_experiments_tpu.validation import checks


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="module")
def small_flagship():
    from mitsuba3_experiments_tpu.scene.flagship import load_flagship

    return load_flagship(res=(64, 36), spp=4, tri_budget=20_000,
                         cache_dir=None)[0]


def test_transforms_match_float64():
    out = checks.check_transforms(n=1 << 14)
    assert max(out.values()) <= checks.TRANSFORM_RTOL


def test_cornell_matches_numpy_oracle():
    out = checks.check_cornell_oracle(res=16, spp=32, depth=4)
    assert out["worst_block_over_bound"] <= 1.0


def test_replay_grads_match_scan_ad():
    out = checks.check_replay_vs_scan_ad(res=16, spp=2, depth=3)
    assert {k.split(":")[0] for k in out} == {"full", "sorted"}
    assert max(out.values()) <= 1.0


@pytest.fixture(scope="module")
def small_pipelined(small_flagship):
    from mitsuba3_experiments_tpu.integrators.pipelined import (
        render_pipelined,
    )

    return render_pipelined(small_flagship, seed=2, spp=4, max_depth=4,
                            rr_depth=3, rfilter="tent", n_lanes=1024,
                            steps=8, rounds_per_launch=4)


def test_pipelined_matches_lockstep_on_flagship(small_flagship,
                                                small_pipelined):
    out = checks.check_pipelined_vs_lockstep(
        small_flagship, small_pipelined, seed=2, spp=4, max_depth=4,
        rr_depth=3, rfilter="tent", block=4)
    assert out["worst_block_sigma"] <= checks.PIPE_K_SIGMA


@pytest.mark.parametrize("bias", ["twice as bright", "paths cut at 2"])
def test_pipelined_vs_lockstep_catches_a_bias(small_flagship,
                                              small_pipelined, bias):
    """The statistic has power against independent noise: the pipelined
    image made 2x brighter, or compared with a lockstep render whose paths
    stop after 2 bounces (no deep indirect light), fails the check.  At
    64x36 spp 4 the global standard error is ~8% of the mean."""
    img, depth = ((small_pipelined * 2.0, 4) if bias == "twice as bright"
                  else (small_pipelined, 2))
    with pytest.raises(AssertionError):
        checks.check_pipelined_vs_lockstep(
            small_flagship, img, seed=2, spp=4, max_depth=depth,
            rr_depth=3, rfilter="tent", block=4)


def test_same_samples_check():
    """Two machines rendering the same samples pass compare_same_samples;
    a render with another seed (same estimator, other noise) fails it."""
    from mitsuba3_experiments_tpu.integrators.persistent import (
        render_persistent,
    )
    from mitsuba3_experiments_tpu.integrators.pipelined import (
        render_pipelined,
    )
    from mitsuba3_experiments_tpu.scene import cornell_box, load_dict

    box, _ = load_dict(cornell_box(res=16))
    kw = dict(spp=2, max_depth=3, rr_depth=2, n_lanes=128, steps=8,
              rounds_per_launch=4)
    a = render_persistent(box, seed=3, **kw)
    out = checks.compare_same_samples(render_pipelined(box, seed=3, **kw), a)
    assert out["pixels_differing"] <= checks.SAME_PIXEL_SHARE
    with pytest.raises(AssertionError):
        checks.compare_same_samples(render_persistent(box, seed=4, **kw), a)


@pytest.mark.gpu
def test_gpu_transforms_match_float64(gpu):
    checks.check_transforms()


@pytest.mark.gpu
def test_gpu_cornell_matches_numpy_oracle(gpu):
    checks.check_cornell_oracle()


@pytest.mark.gpu
def test_gpu_replay_grads_match_scan_ad(gpu):
    checks.check_replay_vs_scan_ad()


@pytest.mark.gpu
def test_gpu_pipelined_matches_lockstep_on_flagship(gpu):
    import bench

    scene = bench.load_scene()
    img = bench.forward(scene, bench.CONFIGS["d8"], 1)
    checks.check_pipelined_vs_lockstep(
        scene, img, seed=1, spp=4, max_depth=8, rr_depth=4, rfilter="tent",
        chunk=1 << 19)
