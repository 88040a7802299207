"""ESRGAN model (the JAX package's `models/esrgan.py`): evaluation, and the GAN
trainer with the U-Net SN discriminator.

The generator is the port's SSR_RRDBNet: on the card its trunk runs the RDB
kernel, in training too (ops/cuda/rdb.py's autograd Function: the kernel's
forward, cuDNN's conv gradients from the saved concat). `num_in_ch` is
derived from the train dataset's n_s2_images and bands, with the JAX
package's warning when the config disagrees; `compute_dtype` and
`matmul_precision` act as in the infer CLI. Evaluation runs the loaded
`param_key_g` weights (params_ema by default), or the EMA while training.

One train iteration (`train_iter`), as the JAX step (esrgan.py:266-336):
- uint8 batch -> [0, 1] float32; the GT sharpened by USM for the losses
  that ask for it (l1_gt_usm, percep_gt_usm, gan_gt_usm); the LR upsampled
  x`scale` (nearest) and/or the old NAIP concatenated onto the
  discriminator's input (feed_disc_lr, old_naip_path);
- G step, gated by net_d_iters / net_d_init_iters (a skipped step runs the
  plain G forward and logs zeros): L1 pixel + VGG19 perceptual (+ SSIM
  against the perceptual GT with `ssim_opt`) + GAN loss through D with one
  power iteration, D's weights taking no gradient (+ with `clip_opt` the
  CLIP loss against the L1 GT, losses/clip.py, added last as the JAX step
  adds it); Adam;
- D step on the real and the detached fake (the pre-update G's output),
  one power iteration each, in that order; Adam;
- EMA of the generator.
G, D and the VGG tower compute in `compute_dtype` (the SSIM loss and the
CLIP tower in float32); all weights, the Adam states and the EMA are
float32. The CLIP tower is frozen and no part of G's optimizer, EMA or
checkpoints. With `train.accum_steps` k > 1 a step takes k x b rows in k
micro-batches of b (`_train_step`, as the JAX `_build_accum_train_step`,
esrgan.py:338-434): the G phase's k forwards and backwards (D's u/v
advancing through each fake pass), one G update, then the D phase's k
real/fake pairs (USM and the input prep recomputed per micro-batch, the k
G outputs carried over), one D update; the gradients summed over the
micro-batches then divided by k, the logs their mean. Across processes
(world_size > 1) each phase's gradients then become their mean over the
ranks (G's in the G phase, D's in the D phase; D takes no gradient in the
G phase) and the logs their global means; D's u/v and the EMA follow from
replicated weights, so every replica stays bit-equal. The OSM-object
trainer (models/osm_esrgan.py) extends this one through `_build_disc`,
`_g_gan_losses` and `_d_loss_and_aux`, which take the step's object boxes.
On a row-band layout (`spatial_shards` S > 1; models/base.py, "Row bands")
every rank of a data group takes the group's rows whole, runs the USM on
the whole GT, and then G, D, VGG19 and the SSIM loss on its band; the CLIP
loss runs on the gathered images (`_whole`), on every rank of the group.
The remat modes rerun the band blocks, their halo exchanges included.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..archs import RRDBNet, UNetDiscriminatorSN
from ..inference import _precision
from ..losses import build_loss, gan_loss
from ..ops.resize import upsample_nearest
from ..ops.usm import usm_sharp
from ..parallel.halo import gather_rows
from ..parallel.mesh import all_reduce_mean_, mean_across_processes
from ..registry import MODEL_REGISTRY
from ..utils.checkpoint import jax_step
from ..utils.model_utils import compute_dtype
from ..utils.torch_io import rrdbnet_from_jax, rrdbnet_to_jax, unet_disc_from_jax, unet_disc_to_jax
from .base import BaseModel, build_optimizer, ema_update, mean_grads, mean_logs, set_lr


@MODEL_REGISTRY.register("SSRESRGANModel")
class ESRGANModel(BaseModel):
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        train = bool(opt.get("is_train"))
        super().__init__(opt, device)
        self.scale = int(opt.get("scale", 4))
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
        seed = int(opt.get("manual_seed", 0) or 0)
        net_g = RRDBNet(
            num_in_ch=self.num_in_ch, num_out_ch=int(g_opt.get("num_out_ch", 3)),
            scale=int(g_opt.get("scale", self.scale)), num_feat=int(g_opt.get("num_feat", 64)),
            num_block=int(g_opt.get("num_block", 23)), num_grow_ch=int(g_opt.get("num_grow_ch", 32)),
            dtype=self.dtype, seed=seed, device="cpu", remat=g_opt.get("remat", False))
        if not train:
            self.net_g = self._place_net(net_g)
            return
        self._build_trainer(opt, net_g, seed)

    # -- trainer build -----------------------------------------------------------

    def _build_trainer(self, opt: Dict[str, Any], net_g: RRDBNet, seed: int) -> None:
        train_opt = opt["train"]
        pre_g = self.load_pretrained("network_g", "pretrain_network_g")
        if pre_g is not None:
            net_g.load_state_dict(pre_g)
        self.net_g = net_g.to(self.device).train()  # float32 master weights

        self.feed_disc_lr = bool(opt.get("feed_disc_lr", False))
        self.has_old_hr = bool(((opt.get("datasets") or {}).get("train") or {}).get("old_naip_path"))
        self.l1_gt_usm = bool(opt.get("l1_gt_usm", True))
        self.percep_gt_usm = bool(opt.get("percep_gt_usm", True))
        self.gan_gt_usm = bool(opt.get("gan_gt_usm", False))

        d_opt = dict(opt["network_d"])
        disc_in = 3 + (self.num_in_ch if self.feed_disc_lr else 0) + (3 if self.has_old_hr else 0)
        if int(d_opt.get("num_in_ch", disc_in)) != disc_in:
            self.logger.warning(f"network_d.num_in_ch={d_opt.get('num_in_ch')} inconsistent with "
                                f"conditioning flags; using {disc_in}.")
        net_d = self._build_disc(disc_in, d_opt, seed)
        pre_d = self.load_pretrained("network_d", "pretrain_network_d")
        if pre_d is not None:
            net_d.load_state_dict(pre_d)
        self.net_d = net_d.to(self.device).train()

        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        percep_opt = dict(train_opt.get("perceptual_opt") or {})
        if percep_opt:  # the VGG tower computes in the model's dtype unless the config says
            percep_opt["dtype"] = (compute_dtype({"compute_dtype": percep_opt["dtype"]})
                                   if "dtype" in percep_opt else self.dtype)
        self.cri_perceptual = build_loss(percep_opt) if percep_opt else None
        self._has_percep = bool(percep_opt) and float(percep_opt.get("perceptual_weight", 1.0)) > 0
        self._has_style = bool(percep_opt) and float(percep_opt.get("style_weight", 0) or 0) > 0
        self.cri_gan = build_loss(train_opt["gan_opt"]) if train_opt.get("gan_opt") else gan_loss()
        self.ssim_loss = build_loss(train_opt["ssim_opt"]) if train_opt.get("ssim_opt") else None
        self.clip_sim = build_loss(train_opt["clip_opt"]) if train_opt.get("clip_opt") else None
        self.net_d_iters = int(train_opt.get("net_d_iters", 1))
        self.net_d_init_iters = int(train_opt.get("net_d_init_iters", 0))

        self.opt_g = build_optimizer(train_opt["optim_g"], self.net_g.parameters())
        self.sched_g = self.make_schedule(train_opt["optim_g"])
        self.opt_d = build_optimizer(train_opt["optim_d"], self.net_d.parameters())
        self.sched_d = self.make_schedule(train_opt["optim_d"])
        #: completed optimizer updates of each network (their schedules' step)
        self.g_updates = self.d_updates = 0
        self.net_g_ema: Optional[RRDBNet] = None
        if self.ema_decay > 0:
            self.net_g_ema = copy.deepcopy(self.net_g).requires_grad_(False)
        self.log_dict: Dict[str, torch.Tensor] = {}
        #: set to a list to record (phase, CUDA event) marks through each step
        self.split_events: Optional[List] = None

    def _build_disc(self, disc_in: int, d_opt: Dict[str, Any], seed: int) -> torch.nn.Module:
        return UNetDiscriminatorSN(disc_in, int(d_opt.get("num_feat", 64)),
                                   bool(d_opt.get("skip_connection", True)), seed=seed,
                                   device="cpu")

    # -- one step ----------------------------------------------------------------

    def _mark(self, name: str) -> None:
        if self.split_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.split_events.append((name, ev))

    def _g(self, lr: torch.Tensor) -> torch.Tensor:
        """G on the LR input: the whole image, or this rank's band."""
        if self.space is None:
            return self.net_g(lr)
        return self.net_g.forward_band(lr, self.space)

    def _disc(self, *inputs, **kw):
        """D on its inputs: the whole image, or this rank's band."""
        if self.space is None:
            return self.net_d(*inputs, **kw)
        return self.net_d.forward_band(*inputs, space=self.space, **kw)

    def _whole(self, img: torch.Tensor) -> torch.Tensor:
        """The whole image from this rank's band (differentiable; the image
        itself without a layout)."""
        return gather_rows(img, self.space)

    def _disc_input(self, img, lr_resized, old_hr):
        parts = [img]
        if self.feed_disc_lr:
            parts.append(lr_resized)
        if self.has_old_hr and old_hr is not None:
            parts.append(old_hr)
        return torch.cat([p.float() for p in parts], dim=-1) if len(parts) > 1 else img

    def _lr_band(self, lr: torch.Tensor) -> torch.Tensor:
        factor, least = self.net_g.band_rows
        return self.band(lr, 1, factor, least, "LR input")

    def _hr_band(self, hr: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if hr is None or self.space is None:
            return hr
        factor = self.net_d.BAND_FACTOR
        if self.cri_perceptual is not None:
            factor = max(factor, self.cri_perceptual.band_factor)
        return self.band(hr, 1, factor, 3 if self.ssim_loss is not None else 1, "HR image")

    def _prep_step_inputs(self, lr_u8, hr_u8, old_hr_u8):
        """uint8 batch -> normalised lr/old_hr and the USM-selected GTs (on a
        row-band layout this rank's bands of them, the USM run on the whole
        GT first)."""
        lr = self._lr_band(lr_u8.float() / 255.0)
        gt = hr_u8.float() / 255.0
        old_hr = self._hr_band(old_hr_u8.float() / 255.0 if old_hr_u8 is not None else None)
        gt_usm = self._hr_band(usm_sharp(gt))
        gt = self._hr_band(gt)
        l1_gt = gt_usm if self.l1_gt_usm else gt
        percep_gt = gt_usm if self.percep_gt_usm else gt
        gan_gt = gt_usm if self.gan_gt_usm else gt
        return lr, old_hr, l1_gt, percep_gt, gan_gt, upsample_nearest(lr, self.scale)

    def _g_content_losses(self, out, l1_gt, percep_gt):
        total = torch.zeros((), dtype=torch.float32, device=out.device)
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(out, l1_gt)
            total = total + l_pix
            logs["l_g_pix"] = l_pix
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(out, percep_gt, self.space)
            if l_percep is not None:
                total = total + l_percep
                logs["l_g_percep"] = l_percep
            if l_style is not None:
                total = total + l_style
                logs["l_g_style"] = l_style
        if self.ssim_loss is not None:
            l_ssim = self.ssim_loss(out, percep_gt, self.space)
            total = total + l_ssim
            logs["l_g_ssim"] = l_ssim
        return total, logs

    def _g_gan_losses(self, out, disc_in, boxes):
        """The generator's GAN terms: D judges its output (one power iteration)."""
        fake_pred = self._disc(disc_in, update_stats=True, dtype=self.dtype)
        l_gan = self.cri_gan(fake_pred, True, is_disc=False)
        return l_gan, {"l_g_gan": l_gan}

    def _g_loss_and_aux(self, lr, l1_gt, percep_gt, lr_resized, old_hr, boxes=None):
        """Generator loss of one (micro-)batch; D advances its power
        iteration but takes no gradient."""
        out = self._g(lr.to(self.dtype))
        self._mark("g_forward_trunk")
        total, logs = self._g_content_losses(out, l1_gt, percep_gt)
        l_gan, gan_logs = self._g_gan_losses(out, self._disc_input(out, lr_resized, old_hr), boxes)
        total, logs = total + l_gan, {**logs, **gan_logs}
        if self.clip_sim is not None:
            self._mark("g_losses")
            l_clip = self.clip_sim(self._whole(out), self._whole(l1_gt))
            total, logs["l_clip_sim"] = total + l_clip, l_clip
            self._mark("g_clip")
        return total, logs, out

    def _d_loss_and_aux(self, real, fake, lr_resized, old_hr, boxes=None):
        """D's loss on the real image and the detached fake, in that order."""
        real_pred = self._disc(self._disc_input(real, lr_resized, old_hr), update_stats=True,
                               dtype=self.dtype)
        l_d_real = self.cri_gan(real_pred, True, is_disc=True)
        fake_pred = self._disc(self._disc_input(fake, lr_resized, old_hr), update_stats=True,
                               dtype=self.dtype)
        l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
        logs = {"l_d_real": l_d_real, "l_d_fake": l_d_fake,
                "out_d_real": real_pred.mean(), "out_d_fake": fake_pred.mean()}
        return l_d_real + l_d_fake, logs

    def _g_log_keys(self) -> List[str]:
        """The keys a G update logs (a skipped one logs zeros under them)."""
        keys = ["l_g_pix"] if self.cri_pix is not None else []
        if self._has_percep:
            keys.append("l_g_percep")
        if self._has_style:
            keys.append("l_g_style")
        if self.ssim_loss is not None:
            keys.append("l_g_ssim")
        return keys + ["l_g_gan"] + (["l_clip_sim"] if self.clip_sim is not None else [])

    def _train_step(self, lr_k, hr_k, old_k, boxes_k) -> Dict[str, torch.Tensor]:
        """One update from k micro-batches (lists of uint8 tensors; k = 1
        without accumulation; old_k, boxes_k lists or None), as the JAX
        steps (the plain one and `_build_accum_train_step`): the G phase
        runs forward and backward per micro-batch, D's power iteration
        advancing at each, the gradients summed then divided by k, one Adam
        update; the D phase the same over (real, detached fake) pairs, the
        inputs' prep recomputed per micro-batch; the logs the mean over
        micro-batches."""
        self.step += 1
        it = self.step
        k = len(lr_k)
        self._mark("start")
        pick = lambda seq, j: None if seq is None else seq[j]
        preps = [None] * k

        def prep(j):
            if preps[j] is not None:
                return preps[j]
            out = self._prep_step_inputs(lr_k[j], hr_k[j], pick(old_k, j))
            if k == 1:  # nothing to save by recomputing
                preps[j] = out
            return out

        outs: List[torch.Tensor] = []
        if it % self.net_d_iters == 0 and it > self.net_d_init_iters:
            self.net_d.requires_grad_(False)
            self.opt_g.zero_grad(set_to_none=True)
            logs_k = []
            try:
                for j in range(k):
                    lr, old_hr, l1_gt, percep_gt, _, lr_resized = prep(j)
                    total, logs, out = self._g_loss_and_aux(lr, l1_gt, percep_gt, lr_resized,
                                                            old_hr, pick(boxes_k, j))
                    self._mark("g_forward")
                    total.backward()
                    self._mark("g_backward")
                    outs.append(out.detach())
                    logs_k.append(logs)
            finally:
                self.net_d.requires_grad_(True)
            mean_grads(self.net_g.parameters(), k)
            all_reduce_mean_(self.net_g.parameters(), "g")
            set_lr(self.opt_g, self.sched_g(self.g_updates))
            self.opt_g.step()
            self.g_updates += 1
            self.net_g.invalidate_packs()
            logs = mean_logs(logs_k)
            self._mark("g_optimizer")
        else:
            with torch.no_grad():
                outs = [self._g(self._lr_band(lr_k[j].float() / 255.0).to(self.dtype))
                        for j in range(k)]
            logs = {name: torch.zeros((), dtype=torch.float32, device=lr_k[0].device)
                    for name in self._g_log_keys()}
            self._mark("g_forward_trunk")
            self._mark("g_forward")
            self._mark("g_backward")
            self._mark("g_optimizer")

        self.opt_d.zero_grad(set_to_none=True)
        d_logs_k = []
        for j in range(k):
            _, old_hr, _, _, gan_gt, lr_resized = prep(j)
            l_d, d_logs = self._d_loss_and_aux(gan_gt, outs[j], lr_resized, old_hr,
                                               pick(boxes_k, j))
            l_d.backward()
            d_logs_k.append(d_logs)
        mean_grads(self.net_d.parameters(), k)
        all_reduce_mean_(self.net_d.parameters(), "d")
        self._mark("d_forward_backward")
        set_lr(self.opt_d, self.sched_d(self.d_updates))
        self.opt_d.step()
        self.d_updates += 1
        if self.net_g_ema is not None:
            ema_update(list(self.net_g_ema.parameters()),
                       [p.detach() for p in self.net_g.parameters()], self.ema_decay)
            self.net_g_ema.invalidate_packs()
        self._mark("optimizer_ema")
        return mean_across_processes({**logs, **mean_logs(d_logs_k)})

    def _step_boxes(self, batch: Dict[str, Any], current_iter: int) -> Optional[np.ndarray]:
        """The iteration's object boxes [B, K, 4]: none here (the OSM trainer's)."""
        return None

    def train_iter(self, batch: Dict[str, Any], current_iter: int) -> Dict[str, torch.Tensor]:
        """One GAN iteration on a uint8 batch of accum_steps x b rows (split
        into k micro-batches of b); returns the loss dict (device scalars,
        floated by the caller at print_freq)."""
        old_hr = batch.get("old_hr") if self.has_old_hr else None
        boxes = self._step_boxes(batch, current_iter)
        with _precision(self.matmul_precision):
            logs = self._train_step(self.micro_batches(batch["lr"]),
                                    self.micro_batches(batch["hr"]),
                                    None if old_hr is None else self.micro_batches(old_hr),
                                    None if boxes is None else self.micro_batches(boxes))
        self.log_dict = logs
        return logs

    # -- eval, checkpoints ---------------------------------------------------------

    def eval_net(self) -> torch.nn.Module:
        ema = getattr(self, "net_g_ema", None)
        return self.net_g if ema is None else ema

    def network_checkpoints(self) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        return {"g": {"params": self.net_g.state_dict(),
                      "params_ema": self.eval_net().state_dict()},
                "d": {"params": self.net_d.state_dict()}}

    def train_state(self) -> Dict[str, Any]:
        state = {"step": self.step,
                 "g": {"params": self.net_g.state_dict(), "opt": self.opt_g.state_dict(),
                       "updates": self.g_updates},
                 "d": {"params": self.net_d.state_dict(), "opt": self.opt_d.state_dict(),
                       "updates": self.d_updates}}
        if self.net_g_ema is not None:
            state["ema"] = self.net_g_ema.state_dict()
        return state

    #: the discriminator's state dict <-> the JAX package's variables
    disc_to_jax = staticmethod(unet_disc_to_jax)
    disc_from_jax = staticmethod(unet_disc_from_jax)

    def jax_network_checkpoints(self) -> Dict[str, Dict[str, Any]]:
        """net_g: params + params_ema (the EMA, or the params without one),
        net_d: params + spectral, as the JAX trainer's .msgpack files."""
        g = lambda net: rrdbnet_to_jax(net.state_dict())["params"]
        return {"g": {"params": g(self.net_g), "params_ema": g(self.eval_net())},
                "d": self.disc_to_jax(self.net_d.state_dict())}

    def train_state_from_jax(self, state: Dict[str, Any]) -> Dict[str, Any]:
        g_opt = self._adam_from_jax(state["g"]["opt"], rrdbnet_from_jax, self.net_g, self.opt_g)
        d_opt = self._adam_from_jax(state["d"]["opt"], self.disc_from_jax, self.net_d, self.opt_d)
        out = {"step": jax_step(state["step"]),
               "g": {"params": rrdbnet_from_jax({"params": state["g"]["params"]}), "opt": g_opt,
                     "updates": int(g_opt["state"][0]["step"])},
               "d": {"params": self.disc_from_jax(state["d"]), "opt": d_opt,
                     "updates": int(d_opt["state"][0]["step"])}}
        if "ema" in state:
            out["ema"] = rrdbnet_from_jax({"params": state["ema"]})
        return out

    def load_train_state(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        for net, opt, key in ((self.net_g, self.opt_g, "g"), (self.net_d, self.opt_d, "d")):
            net.load_state_dict(state[key]["params"])
            opt.load_state_dict(state[key]["opt"])
        self.g_updates, self.d_updates = int(state["g"]["updates"]), int(state["d"]["updates"])
        self.net_g.invalidate_packs()
        if self.net_g_ema is not None:
            self.net_g_ema.load_state_dict(state["ema"])
            self.net_g_ema.invalidate_packs()
