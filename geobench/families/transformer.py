"""The port's GPT-style LM (``geomx_tpu_torch/models/transformer.py``)
at a configuration's sizes."""

from __future__ import annotations

import torch


def grad_fn(config: dict, device):
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    make_lm_grad_fn)

    m = config["model"]
    cfg = TransformerConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=m["n_layers"], d_ff=m["d_ff"], max_seq=m["max_seq"],
        attn_impl=m["attn_impl"],
        compute_dtype=getattr(torch, m["compute_dtype"]))
    return make_lm_grad_fn(cfg)
