"""MixedSync and partition catch-up with a compressed WAN: the port
against the JAX package's numpy merge path.

``tests/test_torch_mixed_sync.py`` holds the port's torch backend to the
port's own numpy backend, and runs on the card without JAX. Here the
same scenarios run on ``geomx_tpu.kvstore.Simulation`` with
``merge_backend="numpy"`` (host codecs, host DC-ASGD, host Adam) as the
reference, and both of the port's backends are held to it:

- 2 × 2 + 1 MixedSync, DC-ASGD under ``2bit`` and ``bsc``: the global
  weights equal the reference bit for bit on the port's ``numpy`` and
  ``torch:cpu`` backends;
- the same under Adam: bit for bit on the port's ``numpy`` backend
  (host ``Adam`` on both sides), within rtol 1e-5 on ``torch:cpu``,
  whose device optimizer stage differs from the host ``Adam`` in the
  last bits of its scalar divisions (as in the port-only test);
- a healed party's 2bit catch-up: bit for bit on both backends.
"""

import numpy as np
import pytest

from tests.test_torch_mixed_sync import (  # noqa: F401 (a fixture)
    CODECS, OPTS, _catchup, _mixed, host_bsc_encoder)

BACKENDS = ("numpy", "torch:cpu")


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(*args):
        if args not in cache:
            cache[args] = (_catchup("numpy", pkg="geomx_tpu") if not args
                           else _mixed("numpy", *args, pkg="geomx_tpu"))
        return cache[args]

    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_mixed_sync_compressed_matches_jax(codec, opt, backend, reference,
                                           host_bsc_encoder):
    want = reference(codec, opt)
    got = _mixed(backend, codec, opt)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(want[k]).all() and np.abs(want[k]).max() > 0
        if opt == "adam" and backend != "numpy":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert got[k].tobytes() == want[k].tobytes(), (
                k, float(np.abs(got[k] - want[k]).max()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_partition_catchup_2bit_matches_jax(backend, reference):
    want = reference()
    got = _catchup(backend)
    assert np.abs(want).max() > 0
    assert got.tobytes() == want.tobytes(), float(np.abs(got - want).max())
