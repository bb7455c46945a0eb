"""The backend lane's fourth group: the JAX package's device-backend
contract suites (the merge backend, the device optimizer, the device
codec) and its schedulers (P3, DGT, TSEngine over ``Simulation``) run
against the port on ``torch:cpu``.

The contract suites go in by the contract rewrite
(``_contract_rewrite`` in ``tests/test_torch_runtime_lane_backend.py``:
``JaxBackend`` → ``TorchBackend``, the backend asked for as ``"jax"`` →
the lane's, ``jax.numpy`` and ``np.asarray`` through the written
``lane_contract.py``, the 8 device slots of the JAX suites as 8
single-controller slots on the lane's device); the cases where the port
differs by design are in its ``LEFT_OUT`` with their stand-ins.  On the
card ``chip_smoke.py`` phase 11 runs this group with the others.
"""

import pytest

from tests.test_torch_runtime_lane_backend import GROUPS, check_file


@pytest.mark.parametrize("name", GROUPS["device"])
def test_lane_file_passes_on_the_torch_backend(name, tmp_path):
    check_file(name, tmp_path)
