"""The backend lane's third group: the JAX package's churn, dynamic-join,
robustness, auxiliary (profiler, checkpoint, heartbeat, measure) and
ESync suites run against the port on ``torch:cpu``: joins, leaves,
notices and checkpoints while the servers hold torch state (the runner
and the lists of what it leaves out are in
``tests/test_torch_runtime_lane_backend.py``; the cases that train the
JAX CNN have their port counterparts in
``tests/test_torch_runtime_training.py``).
"""

import pytest

from tests.test_torch_runtime_lane_backend import GROUPS, check_file


@pytest.mark.parametrize("name", GROUPS["churn"])
def test_lane_file_passes_on_the_torch_backend(name, tmp_path):
    check_file(name, tmp_path)
