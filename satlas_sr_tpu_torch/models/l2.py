"""L2 model (SRCNN / HighResNet), eval side (the JAX package's `models/l2.py:28-90,
192, 209-213`).

The generators take the revisits as a 5-D [B, T, H, W, C] stack: a
channel-stacked [B, H, W, T*3] batch is reshaped first. Evaluation runs the
loaded weights (the raw params, as the reference L2Model.test() does).
Training, with the WorldStrat loss, is not yet ported.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..archs import SRCNN, HighResNet
from ..registry import MODEL_REGISTRY
from .base import BaseModel


@MODEL_REGISTRY.register("L2Model")
class L2Model(BaseModel):
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        if opt.get("is_train"):
            raise NotImplementedError("L2Model training is not yet ported (ROADMAP queue 1 item 9)")
        super().__init__(opt, device)
        net_opt = {k: v for k, v in opt["network_g"].items() if k not in ("type", "use_batchnorm")}
        cls = {"SRCNN": SRCNN, "HighResNet": HighResNet}[opt["network_g"]["type"]]
        self.net_g = self._place_net(cls(**net_opt, dtype=self.dtype,
                                         seed=int(opt.get("manual_seed", 0) or 0), device="cpu"))

    def _prep_lr(self, lr_np: np.ndarray) -> np.ndarray:
        if lr_np.ndim == 4:  # channel-stacked -> [B, T, H, W, C]
            b, h, w, tc = lr_np.shape
            lr_np = lr_np.reshape(b, h, w, tc // 3, 3).transpose(0, 3, 1, 2, 4)
        return lr_np
