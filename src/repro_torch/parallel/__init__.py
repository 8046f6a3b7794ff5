"""repro_torch.parallel — sharded execution on DTensor (PyTorch port of the
reference's ``parallel`` package).

* :mod:`.act` — the activation constraints model code calls
  (``constrain``, ``BATCH``, ``TP``, :class:`act.activation_mesh`), and
  :func:`act.per_shard`, which runs a kernel shard by shard;
* :mod:`.sharding` — the partition-spec rules for parameters, optimizer
  state, batches and caches, ``to_shardings`` and ``device_put`` onto a
  ``DeviceMesh``;
* :mod:`.ep_moe` — the explicit expert-parallel MoE forward (two
  all-to-alls on the ``'model'`` axis).

Submodules load on first use: the model code imports :mod:`.act`, and
:mod:`.sharding` imports the model.
"""
import importlib

__all__ = ["P", "param_pspecs", "act", "sharding", "ep_moe"]


def __getattr__(name):
    if name in ("act", "sharding", "ep_moe"):
        return importlib.import_module(f".{name}", __name__)
    if name in ("P", "param_pspecs"):
        return getattr(importlib.import_module(".sharding", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
