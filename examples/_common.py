"""Shared example-driver plumbing (platform pick + repo path)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from mitsuba3_experiments_tpu.utils.cache import enable_compile_cache  # noqa: E402

if os.environ.get("EX_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
