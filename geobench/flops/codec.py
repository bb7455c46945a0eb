"""Bytes of the hand codec kernels (``csrc/quantize.cu``) on a key of
``n`` elements, each input read once and each output written once
(``chip_smoke.py`` ``kernel_costs``, copied): ``dgc_update`` reads
velocity, accumulation and gradient, and writes velocity and
accumulation.
"""

from __future__ import annotations


def nbytes(kind: str, n: int) -> int:
    return {"dgc_update": 20 * n}[kind]


def kernel_kind(name: str):
    """The codec kernel a trace entry's name belongs to, or None."""
    if "dgc_update" in name:
        return "dgc_update"
    return None
