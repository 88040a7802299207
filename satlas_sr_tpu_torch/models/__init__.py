"""Model registry package (importing registers the eval models)."""

from ..registry import MODEL_REGISTRY
from .esrgan import ESRGANModel
from .l2 import L2Model
from .osm_esrgan import OSMObjESRGANModel


def build_model(opt: dict, device="cuda"):
    """MODEL_REGISTRY lookup from opt['model_type'] (basicsr build_model parity)."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)


__all__ = ["build_model", "ESRGANModel", "L2Model", "OSMObjESRGANModel"]
