"""The backend lane's fifth group, run on the host only: the JAX
package's record-IO and iterator suite, its native host codec library
suite, its multihost launch (every role its own process on its own
loopback address, each launcher with ``--device cpu``; the JAX package
marks it ``slow``, the lane runs it) and its ``docs/metrics.md`` check
against every metric the port registers.

None of them holds device state (no merge backend, no tensor), so the
card (``chip_smoke.py`` phase 11) does not run them: there they would
cost time and test nothing the host run does not.
"""

import pytest

from tests.test_torch_runtime_lane_backend import GROUPS, check_file


@pytest.mark.parametrize("name", GROUPS["host"])
def test_lane_file_passes_on_the_host(name, tmp_path):
    check_file(name, tmp_path)
