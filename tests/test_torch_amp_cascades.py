"""The bf16 mixed-precision checks of ``test_torch_amp.py`` (module dtypes,
values within test_amp.py's budgets, one AMP step against JAX's) on the
MaskFiner cascades: ``maskfiner_from_config``,
``maskfiner_oracle_teacher_from_config`` and
``maskfiner_oracle_teacher_bb_from_config``, each at its own test module's
tiny size.  A file of its own, so that another test worker takes these
three JAX compiles.
"""

import pytest

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_amp import (CASCADES, amp_reference,  # noqa: F401 (collected here too)
                            test_amp_module_dtypes_match_jax,
                            test_amp_outputs_within_budget_of_jax,
                            test_amp_step_keeps_fp32_masters_and_matches_jax_losses)


@pytest.fixture(scope="module", params=CASCADES)
def amp(request):
    return amp_reference(request.param)
