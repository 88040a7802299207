"""ESRGAN model, eval side (the JAX package's `models/esrgan.py:43-93, 455-494`).

The generator is the port's SSR_RRDBNet, so on the card its trunk runs the
RDB kernel (ops/cuda/rdb.py). `num_in_ch` is derived from the train
dataset's n_s2_images and bands, with the JAX package's warning when the
config's value disagrees; `compute_dtype` and `matmul_precision` act as in
the infer CLI. Evaluation runs the loaded `param_key_g` weights (params_ema
by default, falling back to params). Training is not yet ported.
"""

from __future__ import annotations

from typing import Any, Dict

from ..archs import RRDBNet
from ..registry import MODEL_REGISTRY
from .base import BaseModel


@MODEL_REGISTRY.register("SSRESRGANModel")
class ESRGANModel(BaseModel):
    #: ROADMAP queue 1 item that ports this model's trainer
    train_item = 10

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        if opt.get("is_train"):
            raise NotImplementedError(f"{type(self).__name__} training is not yet ported "
                                      f"(ROADMAP queue 1 item {self.train_item})")
        super().__init__(opt, device)
        g_opt = dict(opt["network_g"])
        # reference configs carry stale num_in_ch: derive it from the train
        # dataset's n_s2_images * channels per frame
        ds_train = (opt.get("datasets") or {}).get("train") or {}
        if ds_train:
            bands = ds_train.get("s2_bands") or ["tci"]
            derived = int(ds_train.get("n_s2_images", 8)) * (3 + (len(bands) - 1))
            if int(g_opt.get("num_in_ch", derived)) != derived:
                self.logger.warning(
                    f"network_g.num_in_ch={g_opt.get('num_in_ch')} inconsistent with "
                    f"dataset (n_s2_images*channels={derived}); using {derived}.")
            g_opt["num_in_ch"] = derived
        self.num_in_ch = int(g_opt["num_in_ch"])
        self.net_g = self._place_net(RRDBNet(
            num_in_ch=self.num_in_ch, num_out_ch=int(g_opt.get("num_out_ch", 3)),
            scale=int(g_opt.get("scale", 4)), num_feat=int(g_opt.get("num_feat", 64)),
            num_block=int(g_opt.get("num_block", 23)), num_grow_ch=int(g_opt.get("num_grow_ch", 32)),
            dtype=self.dtype, seed=int(opt.get("manual_seed", 0) or 0), device="cpu"))
