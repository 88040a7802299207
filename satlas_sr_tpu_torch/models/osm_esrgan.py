"""OSM-object ESRGAN model: the ESRGAN trainer plus an object-level GAN game
over OSM boxes (the JAX package's `models/osm_esrgan.py`;
ssr/models/osm_objs_esrgan_model.py).

At evaluation it is the ESRGAN generator alone. In training:
- `osm_objs_path` (osm_chips_to_masks.json: chip -> {class: [boxes]}) is
  read at build, with `osm_obj_weight` and `n_osm_objs`;
- each iteration samples n_osm_objs boxes a chip on the host (`_sample_boxes`:
  the whole image for a chip without boxes, a degenerate box widened by one
  pixel) from np.random.RandomState((manual_seed * 7919 + iter) % (2^31 - 1)),
  the JAX trainer's draw, so both pick the same boxes;
- the crops of those boxes, resized to 32x32 (ops/crop.py), of the generator's
  output and of the GAN GT go to the OSMObjDiscriminator's object branch:
  the G loss adds osm_obj_weight x the object GAN loss of its crops, and
  the D loss adds it for the real crops and for the detached fake crops,
  both judged target_is_real=True (the reference's quirk, kept).
The spectral u/v advance in the order of the ESRGAN step: the G step's D
forward, D on real, D on fake. Extra log keys: l_g_gan_objs,
l_d_real_objs, l_d_fake_objs. With `accum_steps` k > 1 the boxes are drawn
for the whole k x b batch and split with it, [k, b, K, 4], as the JAX
trainer's (osm_esrgan.py:159-300, 335); each micro-batch's G and D passes
take its own slice.
On a row-band layout (models/base.py, "Row bands") the crops come from the
gathered image, so a box that crosses a band edge reads both bands; the
object branch then runs whole on every rank of the group.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch

from ..archs import OSMObjDiscriminator
from ..ops.crop import crop_resize_boxes
from ..registry import MODEL_REGISTRY
from ..utils.torch_io import osm_disc_from_jax, osm_disc_to_jax, osm_disc_to_reference
from .esrgan import ESRGANModel

OBJ_SIZE = 32


@MODEL_REGISTRY.register("OSMObjESRGANModel")
class OSMObjESRGANModel(ESRGANModel):
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        self.osm_obj_weight = float(opt.get("osm_obj_weight", 0.3))
        self.n_osm_objs = int(opt.get("n_osm_objs", 1))
        osm_path = ((opt.get("datasets") or {}).get("train") or {}).get("osm_objs_path")
        self.osm_obj_data: Dict[str, Dict[str, List]] = {}
        if osm_path and opt.get("is_train"):
            with open(osm_path) as f:
                self.osm_obj_data = json.load(f)
        super().__init__(opt, device)

    def _build_disc(self, disc_in: int, d_opt: Dict[str, Any], seed: int) -> torch.nn.Module:
        return OSMObjDiscriminator(disc_in, int(d_opt.get("num_feat", 64)),
                                   bool(d_opt.get("skip_connection", True)), seed=seed,
                                   device="cpu")

    def _objects(self, img: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """The boxes' crops of the whole image (gathered from the bands on a
        row-band layout: the boxes are in the image's coordinates)."""
        img = self._whole(img)
        return crop_resize_boxes(img, boxes, OBJ_SIZE).reshape(-1, OBJ_SIZE, OBJ_SIZE, img.shape[-1])

    def _g_gan_losses(self, out, disc_in, boxes):
        fake_pred, obj_pred = self._disc(disc_in, self._objects(out, boxes), update_stats=True,
                                         dtype=self.dtype)
        l_gan = self.cri_gan(fake_pred, True, is_disc=False)
        l_gan_objs = self.osm_obj_weight * self.cri_gan(obj_pred, True, is_disc=False)
        return l_gan + l_gan_objs, {"l_g_gan": l_gan, "l_g_gan_objs": l_gan_objs}

    def _d_loss_and_aux(self, real, fake, lr_resized, old_hr, boxes=None):
        w = self.osm_obj_weight
        real_pred, real_obj = self._disc(self._disc_input(real, lr_resized, old_hr),
                                         self._objects(real, boxes), update_stats=True,
                                         dtype=self.dtype)
        l_d_real = self.cri_gan(real_pred, True, is_disc=True)
        l_d_real_objs = w * self.cri_gan(real_obj, True, is_disc=True)
        fake_pred, fake_obj = self._disc(self._disc_input(fake, lr_resized, old_hr),
                                         self._objects(fake, boxes), update_stats=True,
                                         dtype=self.dtype)
        l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
        # the reference judges the fake objects as real (osm_objs_esrgan_model.py:301)
        l_d_fake_objs = w * self.cri_gan(fake_obj, True, is_disc=True)
        logs = {"l_d_real": l_d_real, "l_d_fake": l_d_fake, "l_d_real_objs": l_d_real_objs,
                "l_d_fake_objs": l_d_fake_objs, "out_d_real": real_pred.mean(),
                "out_d_fake": fake_pred.mean()}
        return l_d_real + l_d_real_objs + l_d_fake + l_d_fake_objs, logs

    def _g_log_keys(self) -> List[str]:
        return super()._g_log_keys() + ["l_g_gan_objs"]

    def _sample_boxes(self, chips, rng: np.random.RandomState) -> np.ndarray:
        """[B, n_osm_objs, 4] int32 (x1, y1, x2, y2), degenerate boxes widened."""
        batch_boxes = []
        for chip in chips:
            objs = [box for boxes in (self.osm_obj_data.get(chip) or {}).values() for box in boxes]
            if not objs:
                objs = [[0, 0, 128, 128]]
            idx = rng.choice(len(objs), size=self.n_osm_objs, replace=len(objs) < self.n_osm_objs)
            picked = []
            for i in idx:
                x1, y1, x2, y2 = objs[i]
                if x1 == x2:
                    x1, x2 = (x1, x2 + 1) if x2 < 128 else (x1 - 1, x2)
                if y1 == y2:
                    y1, y2 = (y1, y2 + 1) if y2 < 128 else (y1 - 1, y2)
                picked.append([x1, y1, x2, y2])
            batch_boxes.append(picked)
        return np.asarray(batch_boxes, np.int32)

    def _step_boxes(self, batch: Dict[str, Any], current_iter: int) -> np.ndarray:
        rng = np.random.RandomState(
            (int(self.opt.get("manual_seed", 0) or 0) * 7919 + current_iter) % (2 ** 31 - 1))
        #: the boxes of the latest iteration, [B, n_osm_objs, 4] on the host
        self.boxes = self._sample_boxes(batch["Chip"], rng)
        return self.boxes

    disc_to_jax = staticmethod(osm_disc_to_jax)
    disc_from_jax = staticmethod(osm_disc_from_jax)

    def network_checkpoints(self) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        nets = super().network_checkpoints()
        nets["d"] = {"params": osm_disc_to_reference(self.net_d.state_dict())}
        return nets
