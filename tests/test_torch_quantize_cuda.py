"""The CUDA C++ 2-bit quantize and dequantize wrapper
(``geomx_tpu_torch/ops/kernels/quantize_cuda.py``).

On the CPU: the wrapper refuses every input its kernels do not take —
a CPU tensor, a wrong dtype, a 2-D or non-contiguous tensor, a short
code buffer, an unknown layout — before it loads or builds anything, and
importing it builds nothing.  On a CUDA card (tests marked ``cuda``):
both kernels bitwise equal to their plain versions in both layouts, on
views at every 4-byte offset (f32) and every byte offset (codes), and a
dispatcher call launches the CUDA kernels, never the Triton yardstick.

Tolerance everywhere: exact (bit patterns compared).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from geomx_tpu_torch.ops import quantize as Q
from geomx_tpu_torch.ops.kernels import quantize_cuda as C
from geomx_tpu_torch.ops.kernels import quantize_triton as K

THR = 0.5


def _inputs(n, seed=0):
    """Gradient and residual with signed zeros and sums exactly at ±t."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 0.4).astype(np.float32)
    r = (rng.standard_normal(n) * 0.2).astype(np.float32)
    g[0::13] = -0.0
    r[0::13] = -0.0        # r + g = -0.0
    g[1::17] = THR
    r[1::17] = 0.0         # r + g = +t exactly: code 0
    g[2::19] = -THR
    r[2::19] = 0.0         # r + g = -t exactly: code 0
    return g, r


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test if the wrapper loads (and so builds) its library."""
    def refuse():
        raise AssertionError("the wrapper tried to load its library")
    monkeypatch.setattr(C.LIB, "load", refuse)
    yield
    assert C.LIB._lib is None


def test_import_builds_nothing():
    code = (
        "import geomx_tpu_torch.utils.build as B\n"
        "calls = []\n"
        "B.locked_build = lambda *a, **k: calls.append(a)\n"
        "B.NvccLibrary.load = lambda self: calls.append(self)\n"
        "from geomx_tpu_torch.ops import quantize\n"
        "from geomx_tpu_torch.ops.kernels import quantize_cuda as C\n"
        "assert calls == [] and C.LIB._lib is None, calls\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _f32(n=64):
    return torch.zeros(n, dtype=torch.float32)


REFUSED_QUANTIZE = {
    "cpu tensor": (lambda: (_f32(), _f32()), ValueError, "CUDA"),
    "grad dtype": (lambda: (_f32().double(), _f32()), TypeError, "float32"),
    "residual dtype": (lambda: (_f32(), _f32().half()), TypeError,
                       "float32"),
    "2-D grad": (lambda: (_f32().view(8, 8), _f32()), ValueError, "1-D"),
    "non-contiguous": (lambda: (_f32(128)[::2], _f32()), ValueError,
                       "contiguous"),
    "length mismatch": (lambda: (_f32(64), _f32(65)), ValueError,
                        "elements"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_QUANTIZE))
def test_quantize_refuses_before_any_build(case, no_build):
    make, exc, match = REFUSED_QUANTIZE[case]
    g, r = make()
    for layout in Q.LAYOUTS:
        with pytest.raises(exc, match=match):
            C.quantize_2bit(g, r, THR, layout)


REFUSED_DEQUANTIZE = {
    "cpu tensor": (lambda: torch.zeros(16, dtype=torch.uint8), ValueError,
                   "CUDA"),
    "dtype": (lambda: torch.zeros(16, dtype=torch.int8), TypeError,
              "uint8"),
    "2-D": (lambda: torch.zeros(4, 4, dtype=torch.uint8), ValueError,
            "1-D"),
    "non-contiguous": (lambda: torch.zeros(32, dtype=torch.uint8)[::2],
                       ValueError, "contiguous"),
    "short payload": (lambda: torch.zeros(15, dtype=torch.uint8),
                      ValueError, "bytes"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_DEQUANTIZE))
def test_dequantize_refuses_before_any_build(case, no_build):
    make, exc, match = REFUSED_DEQUANTIZE[case]
    with pytest.raises(exc, match=match):
        C.dequantize_2bit(make(), 64, THR, "consecutive")


def test_strided_payload_needs_whole_blocks(no_build):
    """A strided code buffer holds whole 32,768-byte blocks: one sized
    for the consecutive layout is short."""
    with pytest.raises(ValueError, match="bytes"):
        C.dequantize_2bit(torch.zeros(16, dtype=torch.uint8), 64, THR,
                          "strided")
    assert C._packed_len(64, 1) == Q.packed_len(64, "strided")
    assert C._packed_len(131_073, 1) == Q.packed_len(131_073, "strided")
    assert C._packed_len(5, 0) == Q.packed_len(5, "consecutive")


@pytest.mark.parametrize("fn", ["quantize", "dequantize"])
def test_unknown_layout_refused_before_any_build(fn, no_build):
    with pytest.raises(ValueError, match="layout"):
        if fn == "quantize":
            C.quantize_2bit(_f32(), _f32(), THR, "stride")
        else:
            C.dequantize_2bit(torch.zeros(16, dtype=torch.uint8), 64, THR,
                              "Strided")


def _view(a: np.ndarray, off: int, dev) -> torch.Tensor:
    """``a`` on the card as a view ``off`` elements into a larger tensor:
    its first element ``off * itemsize`` bytes past an aligned start."""
    base = torch.from_numpy(np.concatenate([np.zeros(off, a.dtype), a]))
    return base.to(dev)[off:]


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 384, 4097, 147_456, 401_408])
def test_kernels_bitwise_equal_to_plain_versions_on_card(n):
    """Codes, residual and decoded values bitwise, both layouts, on views
    at element offsets 0-3 (f32: 0-12 bytes, so only 0 takes the vector
    path) and with gradient and residual off by one from each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    g, r = _inputs(n, seed=n)
    for layout in Q.LAYOUTS:
        for off, r_off in ((0, 0), (1, 1), (2, 2), (3, 3), (0, 1)):
            tg, tr = _view(g, off, dev), _view(r, r_off, dev)
            pk, rk = C.quantize_2bit(tg, tr, THR, layout)
            pp, rp = Q.quantize_2bit_ref(tg, tr, THR, layout)
            torch.cuda.synchronize()
            assert _bits_equal(pk, pp), f"{layout} n={n} off={off}: codes"
            assert _bits_equal(rk, rp), f"{layout} n={n} off={off}: residual"
            codes = _view(pk.cpu().numpy(), off, dev)
            dk = C.dequantize_2bit(codes, n, THR, layout)
            dp = Q.dequantize_2bit_ref(codes, n, THR, layout)
            torch.cuda.synchronize()
            assert _bits_equal(dk, dp), f"{layout} n={n} off={off}: decode"
    # codes that hold 3 (decoded as +0.0, as code 0), in buffers longer
    # than needed (the plain version reads the bytes it needs)
    rng = np.random.default_rng(n + 1)
    for layout in Q.LAYOUTS:
        need = Q.packed_len(n, layout)
        raw = rng.integers(0, 256, need + 5, dtype=np.uint8)
        for off in range(4):
            codes = _view(raw, off, dev)
            dk = C.dequantize_2bit(codes, n, THR, layout)
            dp = Q.dequantize_2bit_ref(codes[:need], n, THR, layout)
            torch.cuda.synchronize()
            assert _bits_equal(dk, dp), f"{layout} n={n} off={off}: raw"


@pytest.mark.cuda
def test_dispatcher_launches_cuda_kernels_not_triton():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    g, r = _inputs(4097)
    tg, tr = torch.from_numpy(g).cuda(), torch.from_numpy(r).cuda()
    cuda0, triton0 = C.launches(), K.launches()
    packed, _ = Q.quantize_2bit(tg, tr, THR)
    Q.dequantize_2bit(packed, 4097, THR)
    torch.cuda.synchronize()
    cuda1, triton1 = C.launches(), K.launches()
    assert cuda1["quantize_2bit"] == cuda0["quantize_2bit"] + 1
    assert cuda1["dequantize_2bit"] == cuda0["dequantize_2bit"] + 1
    assert triton1 == triton0
