"""Part 1 of 3 of the tests in `torch_pipeline_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_pipeline_cases import (  # noqa: F401
    narrow, test_entry_points_need_the_card_unless_asked_for_the_cpu,
    test_configs_stay_the_jax_presets, test_fused_raises_outside_its_scope,
)
