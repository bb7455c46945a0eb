"""The backend lane's second group: the JAX package's partition, serve,
observability, flight-recorder, integrity, zero-copy, trace and stress
suites run against the port on ``torch:cpu`` (the runner and the lists
of what it leaves out are in ``tests/test_torch_runtime_lane_backend.py``).

``test_stress.py`` holds only cases the JAX package marks ``slow``: the
lane runs its two lossy-network soaks (a few seconds on the host) here;
its 50M-element scale run (``HEAVY``: 9.3 GB of host memory) runs in
the ``slow`` ``test_lane_slow_cases`` and on the card.
"""

import pytest

from tests.test_torch_runtime_lane_backend import GROUPS, check_file


@pytest.mark.parametrize("name", GROUPS["serve"])
def test_lane_file_passes_on_the_torch_backend(name, tmp_path):
    check_file(name, tmp_path)
