from .base import (SHAPES, ArchConfig, LayerSpec, ShapeSpec, cells_for,
                   get_config, list_configs, reduced, register)

__all__ = ["SHAPES", "ArchConfig", "LayerSpec", "ShapeSpec", "cells_for",
           "get_config", "list_configs", "reduced", "register"]
