"""Meta-device stand-ins for every model input (no allocation).

The port of the reference's ``launch/specs.py``: where the reference builds
``jax.ShapeDtypeStruct`` leaves (``jax.eval_shape``), this builds tensors
on ``torch.device("meta")``, which carry a shape and a dtype and no data.
``input_specs(cfg, shape)`` gives the batch of a training step; for serving
the request batch (prefill) or the (token, cur_pos) operands (decode).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["input_specs", "train_state_specs", "cache_specs", "META"]

META = torch.device("meta")

#: parameters the model keeps in float32 whatever its param_dtype
_F32_PARAMS = ("A_log", "D")


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.frontend != "none":
            tok = _meta((B, cfg.d_model), M.dtype_of(cfg.compute_dtype))
        else:
            tok = _meta((B,), torch.int32)
        return dict(token=tok, cur_pos=_meta((), torch.int32))
    batch: Dict[str, Any] = {}
    if cfg.frontend != "none":
        batch["embeds"] = _meta((B, S, cfg.d_model),
                                M.dtype_of(cfg.compute_dtype))
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def _param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """``init_params(cfg)``'s tree as meta tensors: each leaf in
    ``param_dtype``, the Mamba ``A_log`` and ``D`` in float32."""
    dtype = M.dtype_of(cfg.param_dtype)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return _meta(tree, torch.float32 if name in _F32_PARAMS else dtype)

    return walk(M.param_shapes(cfg))


def train_state_specs(cfg: ArchConfig, opt_cfg: AdamWConfig
                      ) -> Tuple[Any, Any]:
    """(params, opt_state) as meta tensors (no allocation)."""
    params = _param_specs(cfg)
    return params, adamw_init(params, opt_cfg)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
