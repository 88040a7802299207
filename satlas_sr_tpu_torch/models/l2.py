"""L2 model: SRCNN / HighResNet, evaluation and the trainer with the
WorldStrat loss (the JAX package's `models/l2.py`).

The generators take the revisits as a 5-D [B, T, H, W, C] stack: a
channel-stacked [B, H, W, T*3] batch is reshaped first (`use_3d` datasets
give the stack itself). Evaluation runs the raw params, in training too, as
the reference L2Model.test() does (ssr_l2_model.py:56).

One train iteration (`train_iter`), as the JAX step (l2.py:93-140):
- the uint8 batch is divided by 255 on the device; the network runs in
  train mode (Dropout(0.5) after every PReLU of a DoubleConv2d) in
  `compute_dtype` on float32 weights, and its output [:, 0] is taken;
- loss 0.3 MSE + 0.4 MAE + 0.3 SSIM (window 5) over per-image means
  (ssr_l2_model.py:36-40), logged with mse, mae, ssim, tot_loss and
  psnr_loss = 10 log10(mean MSE);
- Adam with MultiStepLR (models/base.py), then the EMA when ema_decay > 0.
Dropout's keep masks come from `self.dropout_masks` (archs/blocks.py): a
torch.Generator seeded by manual_seed, whose state the training state
keeps; flax draws them from the step's `dropout` key instead, so the two
match only where the masks are handed over (`DropoutMasks.replay`).
With `train.accum_steps` k > 1 (JAX l2.py:151-175) a step takes k x b rows
in k micro-batches, each forward drawing its own masks and running its
backward; the summed gradients are divided by k before the one Adam
update, the logs are the micro-batches' mean, and psnr_loss comes from the
mean MSE (the global batch's), not from a mean of per-micro-batch PSNRs.
Across processes (world_size > 1) the summed gradients become their mean
over the ranks and the logs their global means, psnr_loss from the global
mean MSE; each rank draws the global batch's dropout masks and keeps its
own rows (DropoutMasks' rank and world), so the step equals the
one-process step on the whole batch and the generator state stays equal
on every rank. On a row-band layout (`spatial_shards`; models/base.py,
"Row bands") the network runs `forward_band` on this rank's rows of every
revisit and the loss is taken over the band: the per-image means of the
MSE, MAE and SSIM map are the band's, whose mean over the space group is
the image's (the terms are linear in them), and psnr_loss comes from the
world mean of the MSE. The dropout masks are drawn for the global batch's
whole images and each rank keeps its rows of its band (DropoutMasks' band
and bands), so they are the one-process step's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..archs import SRCNN, HighResNet
from ..archs.blocks import DropoutMasks
from ..inference import _precision
from ..ops.ssim import ssim_loss
from ..parallel.mesh import all_reduce_mean_, mean_across_processes, rank
from ..registry import MODEL_REGISTRY
from ..utils.checkpoint import jax_step
from ..utils.torch_io import highresnet_from_jax, highresnet_to_jax, srcnn_from_jax, srcnn_to_jax
from .base import BaseModel, build_optimizer, ema_update, mean_grads, mean_logs, set_lr


@MODEL_REGISTRY.register("L2Model")
class L2Model(BaseModel):
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        train = bool(opt.get("is_train"))
        super().__init__(opt, device)
        net_opt = {k: v for k, v in opt["network_g"].items() if k not in ("type", "use_batchnorm")}
        cls = {"SRCNN": SRCNN, "HighResNet": HighResNet}[opt["network_g"]["type"]]
        seed = int(opt.get("manual_seed", 0) or 0)
        net = cls(**net_opt, dtype=self.dtype, seed=seed, device="cpu")
        if not train:
            self.net_g = self._place_net(net)
            return
        pre = self.load_pretrained()
        if pre is not None:
            net.load_state_dict(pre)
        self.net_g = net.to(self.device).train()  # float32 master weights
        sp = self.space
        self.dropout_masks = (
            DropoutMasks(seed, self.device, rank=rank(), world=self.world_size) if sp is None else
            DropoutMasks(seed, self.device, rank=sp.data_index, world=sp.data_size,
                         band=sp.space_index, bands=sp.space_size))
        self.net_g.set_dropout_masks(self.dropout_masks)
        optim_opt = opt["train"]["optim_g"]
        self.opt_g = build_optimizer(optim_opt, self.net_g.parameters())
        self.sched_g = self.make_schedule(optim_opt)
        self.ema = ({k: p.detach().clone() for k, p in self.net_g.named_parameters()}
                    if self.ema_decay > 0 else None)
        self.log_dict: Dict[str, torch.Tensor] = {}

    def _prep_lr(self, lr_np: np.ndarray) -> np.ndarray:
        if lr_np.ndim == 4:  # channel-stacked -> [B, T, H, W, C]
            b, h, w, tc = lr_np.shape
            lr_np = lr_np.reshape(b, h, w, tc // 3, 3).transpose(0, 3, 1, 2, 4)
        return lr_np

    def eval_net(self) -> torch.nn.Module:
        return self.net_g.eval()

    # -- one step ----------------------------------------------------------------

    def worldstrat_loss(self, out: torch.Tensor, hr: torch.Tensor):
        """0.3 MSE + 0.4 MAE + 0.3 SSIM over per-image means, and the logs
        (on a row-band layout the band's means: see the module docstring)."""
        out = out.float()
        mse_i = (out - hr).square().mean(dim=(1, 2, 3))
        mae_i = (out - hr).abs().mean(dim=(1, 2, 3))
        ssim_i = ssim_loss(out, hr, window_size=5, space=self.space).mean(dim=(1, 2, 3))
        loss = (0.3 * mse_i + 0.4 * mae_i + 0.3 * ssim_i).mean()
        return loss, {"mse": mse_i.mean(), "mae": mae_i.mean(), "ssim": ssim_i.mean(),
                      "tot_loss": loss}

    def _train_step(self, lr_k, hr_k) -> Dict[str, torch.Tensor]:
        """One update from k micro-batches of uint8 tensors (k = 1 without
        accumulation)."""
        self.net_g.train()
        self.opt_g.zero_grad(set_to_none=True)
        logs_k = []
        for lr_u8, hr_u8 in zip(lr_k, hr_k):
            lr = (lr_u8.float() / 255.0).to(self.dtype)
            if self.space is None:
                out = self.net_g(lr)
            else:
                factor, least = self.net_g.band_rows
                out = self.net_g.forward_band(self.band(lr, 2, factor, least, "LR input"),
                                              self.space)
            loss, logs = self.worldstrat_loss(
                out[:, 0], self.band(hr_u8.float() / 255.0, 1, 1, 3, "HR image"))
            loss.backward()
            logs_k.append(logs)
        mean_grads(self.net_g.parameters(), len(lr_k))
        all_reduce_mean_(self.net_g.parameters(), "g")
        set_lr(self.opt_g, self.sched_g(self.step))
        self.opt_g.step()
        self.step += 1
        if self.ema is not None:
            ema_update(list(self.ema.values()),
                       [p.detach() for _, p in self.net_g.named_parameters()], self.ema_decay)
        logs = mean_across_processes(mean_logs(logs_k))
        logs["psnr_loss"] = 10.0 * torch.log10(logs["mse"])
        return logs

    def train_iter(self, batch: Dict[str, Any], current_iter: int) -> Dict[str, torch.Tensor]:
        """One WorldStrat-loss step on a uint8 batch of accum_steps x b rows;
        returns the loss dict (device scalars, floated by the caller at
        print_freq)."""
        with _precision(self.matmul_precision):
            logs = self._train_step(self.micro_batches(self._prep_lr(np.asarray(batch["lr"]))),
                                    self.micro_batches(batch["hr"]))
        self.log_dict = logs
        return logs

    # -- checkpoints ---------------------------------------------------------------

    def network_checkpoints(self) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        params = self.net_g.state_dict()
        return {"g": {"params": params, "params_ema": params if self.ema is None else self.ema}}

    def train_state(self) -> Dict[str, Any]:
        state = {"step": self.step,
                 "g": {"params": self.net_g.state_dict(), "opt": self.opt_g.state_dict()},
                 "dropout": self.dropout_masks.generator.get_state()}
        if self.ema is not None:
            state["ema"] = self.ema
        return state

    def _jax_io(self):
        arch = self.opt["network_g"]["type"]
        return {"SRCNN": (srcnn_to_jax, srcnn_from_jax),
                "HighResNet": (highresnet_to_jax, highresnet_from_jax)}[arch]

    def jax_network_checkpoints(self) -> Dict[str, Dict[str, Any]]:
        to_jax = self._jax_io()[0]
        params = to_jax(self.net_g.state_dict())["params"]
        ema = params if self.ema is None else to_jax(self.ema)["params"]
        return {"g": {"params": params, "params_ema": ema}}

    def train_state_from_jax(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The JAX L2 state (step, params, opt, rng, ema). Its `rng` (flax's
        dropout key) has no counterpart: the port's masks keep drawing from
        its own generator."""
        from_jax = self._jax_io()[1]
        out = {"step": jax_step(state["step"]),
               "g": {"params": from_jax({"params": state["params"]}),
                     "opt": self._adam_from_jax(state["opt"], from_jax, self.net_g, self.opt_g)}}
        if "ema" in state:
            out["ema"] = from_jax({"params": state["ema"]})
        return out

    def load_train_state(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.net_g.load_state_dict(state["g"]["params"])
        self.opt_g.load_state_dict(state["g"]["opt"])
        if "dropout" in state:  # a JAX state carries none
            self.dropout_masks.generator.set_state(state["dropout"])
        if self.ema is not None:
            for k, v in state["ema"].items():
                self.ema[k].copy_(v)
