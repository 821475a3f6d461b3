"""Part 3 of 3 of the tests in `torch_pipeline_cases.py` (its
docstring says what they hold against the JAX package and at which
tolerance): see ROADMAP.md, "Keep it under its limit"."""

from torch_pipeline_cases import (  # noqa: F401
    narrow, test_generate_full_width_on_the_cpu, test_fastdpm_generate_full_width_on_the_cpu,
)
