"""OSM-object ESRGAN model, eval side (the JAX package's `models/osm_esrgan.py:33`).

At evaluation it is the ESRGAN generator alone: the OSM object crops and
the object discriminator take part only in training, which is not yet
ported (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from ..registry import MODEL_REGISTRY
from .esrgan import ESRGANModel


@MODEL_REGISTRY.register("OSMObjESRGANModel")
class OSMObjESRGANModel(ESRGANModel):
    @classmethod
    def _check_trainable(cls, opt):
        raise NotImplementedError("OSMObjESRGANModel training is not yet ported "
                                  "(ROADMAP queue 1 item 11)")
