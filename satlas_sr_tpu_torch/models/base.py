"""Base model: network build and weight load, the eval forward, validation,
and the trainer's shared parts (the JAX package's `models/base.py`).

- Eval: `to_uint8` (rint, not the infer CLI's truncation), `load_pretrained`,
  and `validation` (the reference's nondist_validation: save pngs, metric
  averaging, best-metric tracking, `(untrained-tower)` tags, per-metric
  ok/fail counts, metrics.jsonl rows). The tower metrics (LPIPS, CLIPScore)
  compute on the model's device under its `matmul_precision`.
- Training: `multistep_lr` (basicsr MultiStepLR/MultiStepRestartLR with
  linear warmup, a pure function of the completed-update count, which sets
  each param group's lr before every step), `build_optimizer` (torch's Adam
  with `weight_decay` is L2 into the gradient, as the JAX package's optax
  chain is), `ema_update`, gradient accumulation (`micro_batches`, the JAX
  `_shard_train_array`; `mean_grads` and `mean_logs`, its `accum_grads`),
  and `save` / `resume_training`: per network a reference-format
  net_{g,d}_{iter}.pth and the JAX package's net_{g,d}_{iter}.msgpack (its
  variables layout, through utils/torch_io.py's `*_to_jax`, so the JAX
  package loads a network the port trained), and an integrity-checked
  training_states/{iter}.state (utils/checkpoint.py: a torch.save payload).
  `resume_training` also takes the JAX package's msgpack .state (told
  apart by its bytes): G and D params, Adam moments and counts, spectral
  u/v, EMA and step, through `train_state_from_jax`. With
  `train.checkpoint_backend: orbax` the state and the nets go to one
  torch.distributed.checkpoint step a save instead (utils/orbax_io.py; the
  .pth mirror stays), the final save skipping a step already written.
- Data parallelism (world_size > 1, a process group from --launcher): each
  rank trains on its own rows; once a step, after the accumulated
  micro-batches, each network's gradients become their mean over the ranks
  (`all_reduce_mean_`) and the logs their global means, so the replicas
  stay bit-equal. Rank 0 alone writes checkpoints and metrics.jsonl.
  Validation shards its loader over the ranks and sums [count, sums, ok,
  fail] over sorted(metrics) across them before averaging.
- Row bands (`spatial_shards: S > 1`, the JAX trainers' ('data', 'space')
  mesh): the world's ranks form world/S data groups of S consecutive ranks
  (`parallel/mesh.mesh_2d`, `self.space`). The S ranks of a group load the
  same rows (the loaders shard by data group), and each runs the step on
  its row band of every image: the band forwards of G and D and of the
  loss towers, with halo rows exchanged around each conv
  (parallel/halo.py, whose collectives are differentiable). A band loss is
  the band's mean; a term that needs the whole image (the OSM objects,
  the CLIP loss) runs whole on every rank of the group from the gathered
  bands. Each rank's loss is then S times its share of the group's loss
  for the band terms and the whole of it for the whole-image terms, and
  every collective's backward is its adjoint: the world mean of the
  gradients (`all_reduce_mean_`, 1/(data groups x S) of their sum) is the
  sum over the space group of the shares, counting a whole-image term
  once, and the mean over the data groups; the logs' world mean likewise.
  The eval forward runs on the bands and gathers uint8 rows; validation
  counts an image once (space index 0 of its group). A layout the
  networks cannot split (a band too short for a halo, rows that do not
  divide by a stride) raises a ValueError naming what it lacks; it never
  falls back to whole rows. The result equals the one-process step on the
  global batch (tests/test_torch_spatial_train.py).

`validation` records where its time goes in `self.timings` (seconds of data
loading, forward, metrics and PNG writes; the forward's includes the copy
back to the host, which waits for the device; `metric_seconds` and
`metric_fail` per metric) and logs it with the record attribute `timings`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..inference import _precision
from ..metrics import calculate_metric
from ..parallel import mesh
from ..parallel.halo import gather_rows
from ..utils.checkpoint import (jax_step, load_network_variables, read_state, save_pytree,
                                save_state)
from ..utils.imgio import write_png
from ..utils.logger import get_root_logger
from ..utils.model_utils import compute_dtype
from ..utils.torch_io import adam_state_from_jax


def multistep_lr(base_lr: float, milestones, gamma: float, warmup_iter: int = -1,
                 restarts=None, restart_weights=None) -> Callable[[int], float]:
    """basicsr MultiStepLR/MultiStepRestartLR + linear warmup, as a pure
    function of `step`, the number of completed updates.

    At a restart the lr resets to base * weight and earlier milestone decays
    are forgotten: lr(s) = base * W[latest restart <= s] * gamma^(#milestones
    in (that restart, s]). Warmup follows basicsr's 1-based current_iter:
    lr = base * (s + 1) / warmup_iter while s + 1 < warmup_iter.
    """
    ms = sorted(int(m) for m in (milestones or []))
    rs = sorted(int(r) for r in (restarts or [0]))
    rw = [float(w) for w in (restart_weights or [1.0] * len(rs))]
    if len(rw) != len(rs):
        raise ValueError(f"restarts ({len(rs)}) and restart_weights ({len(rw)}) must pair up")
    if rs[0] != 0:  # basicsr's implicit first period
        rs, rw = [0] + rs, [1.0] + rw

    def schedule(step: int) -> float:
        r_idx = sum(step >= r for r in rs) - 1
        lr = base_lr * rw[r_idx] * gamma ** sum(rs[r_idx] < m <= step for m in ms)
        if warmup_iter > 0 and step + 1 < warmup_iter:
            lr = base_lr * (step + 1) / warmup_iter
        return lr

    return schedule


def build_optimizer(optim_opt: Dict[str, Any], params: Sequence[torch.Tensor]):
    """The torch optimizer for a YAML `optim_*` block; its lr is set from the
    schedule before every step (`set_lr`)."""
    opt_type = optim_opt.get("type", "Adam")
    lr = float(optim_opt["lr"])
    betas = tuple(float(b) for b in optim_opt.get("betas", [0.9, 0.999]))
    wd = float(optim_opt.get("weight_decay", 0) or 0)
    if opt_type == "Adam":  # weight_decay: L2 into the gradient
        return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)
    if opt_type == "AdamW":  # decoupled decay
        return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)
    if opt_type == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=float(optim_opt.get("momentum", 0.0)))
    raise ValueError(f"Unsupported optimizer {opt_type!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def mean_grads(params, k: int) -> None:
    """Gradients summed over k micro-batch backwards -> their mean: divided
    by k, as the JAX package's `accum_grads` divides its sum (not each
    micro-batch's loss scaled by 1/k before its backward)."""
    if k > 1:
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            torch._foreach_div_(grads, float(k))


def mean_logs(logs_k: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-micro-batch loss dicts -> their mean, detached (the JAX
    accumulated step's jnp.mean over the stacked logs)."""
    if len(logs_k) == 1:
        return {k: v.detach() for k, v in logs_k[0].items()}
    return {k: torch.stack([logs[k].detach() for logs in logs_k]).mean() for k in logs_k[0]}


def _int_opt_keys(tree):
    """An optimizer state dict restored without a template keys its per-param
    state by strings: back to the ints torch's load_state_dict expects."""
    if not isinstance(tree, dict):
        return tree
    if "state" in tree and "param_groups" in tree:
        return {**tree, "state": {int(k): v for k, v in tree["state"].items()}}
    return {k: _int_opt_keys(v) for k, v in tree.items()}


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def to_uint8(img_float: torch.Tensor) -> torch.Tensor:
    """[0,1] float NHWC -> uint8 (tensor2img analog).

    rint, not truncation: basicsr's tensor2img does (img * 255.0).round()
    before the uint8 cast, and validation follows it; the infer CLI
    truncates (inference.py), and the two stay distinct.
    """
    x = img_float.float().clamp(0.0, 1.0) * 255.0
    return torch.round(x).to(torch.uint8)


class BaseModel:
    """Shared eval plumbing; subclasses build `self.net_g` and `_prep_lr`."""

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        self.opt = opt
        self.logger = get_root_logger()
        self.device = resolve_device(device)
        self.world_size = int(opt.get("world_size", 1) or 1)
        if self.world_size != mesh.world_size():
            raise ValueError(f"world_size {self.world_size} but {mesh.world_size()} process(es) "
                             "in the group: start the ranks through --launcher")
        spatial = int(opt.get("spatial_shards", 1) or 1)
        #: this rank's ('data', 'space') layout (the JAX trainers' mesh_2d), or
        #: None: every rank holds whole images
        self.space = mesh.mesh_2d(spatial) if spatial > 1 else None
        self.dtype = compute_dtype(opt)
        train_opt = opt.get("train") or {}
        self.ema_decay = float(train_opt.get("ema_decay", 0) or 0)
        #: micro-batches a train step accumulates (train.accum_steps)
        self.accum_steps = int(train_opt.get("accum_steps", 1) or 1) if opt.get("is_train") else 1
        if self.accum_steps < 1:
            raise ValueError(f"train.accum_steps must be >= 1, got {self.accum_steps}")
        backend = str(train_opt.get("checkpoint_backend") or "native")
        if backend not in ("native", "orbax"):
            raise ValueError(f"train.checkpoint_backend must be 'native' or 'orbax', got {backend!r}")
        self._ckpt_backend = backend
        self._orbax = None
        self._schedules: List[Callable[[int], float]] = []
        #: completed train iterations (the JAX state's `step`)
        self.step = 0
        self.matmul_precision = str(opt.get("matmul_precision", "highest"))
        self.best_metric_results: Dict[str, Dict] = {}
        self.metric_results: Dict[str, float] = {}
        self.timings: Dict[str, Any] = {}

    def load_pretrained(self, net_key: str = "network_g", path_key: str = "pretrain_network_g"):
        """The configured weights as a state dict, or None when none are set."""
        path_opt = self.opt.get("path") or {}
        load_path = path_opt.get(path_key)
        if not load_path:
            return None
        arch_type = self.opt[net_key]["type"]
        param_key = path_opt.get("param_key_g" if net_key == "network_g" else "param_key_d",
                                 "params_ema" if net_key == "network_g" else "params")
        self.logger.info(f"Loading {net_key} from {load_path} (key={param_key})")
        return load_network_variables(arch_type, load_path, self.opt[net_key], param_key)

    # -- training: schedules, checkpoints ------------------------------------

    def make_schedule(self, optim_opt: Dict[str, Any]) -> Callable[[int], float]:
        train_opt = self.opt["train"]
        sched_opt = train_opt.get("scheduler") or {}
        sched_type = sched_opt.get("type", "MultiStepLR")
        if sched_type not in ("MultiStepLR", "MultiStepRestartLR"):
            raise ValueError(f"Unsupported scheduler {sched_type!r}")
        schedule = multistep_lr(float(optim_opt["lr"]), sched_opt.get("milestones", []),
                                float(sched_opt.get("gamma", 0.5)),
                                int(train_opt.get("warmup_iter", -1) or -1),
                                restarts=sched_opt.get("restarts"),
                                restart_weights=sched_opt.get("restart_weights"))
        self._schedules.append(schedule)
        return schedule

    def get_current_learning_rate(self) -> List[float]:
        return [s(self.step) for s in self._schedules]

    def network_checkpoints(self) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        """net name -> {param key: state dict} for its reference-format .pth."""
        raise NotImplementedError

    def train_state(self) -> Dict[str, Any]:
        """Everything a resume needs, as tensors and numbers."""
        raise NotImplementedError

    def load_train_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def jax_network_checkpoints(self) -> Dict[str, Dict[str, Any]]:
        """net name -> the JAX package's variables (numpy) for its .msgpack."""
        raise NotImplementedError

    def train_state_from_jax(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A JAX training state (as flax's msgpack holds it) -> `train_state`'s form."""
        raise NotImplementedError

    def _adam_from_jax(self, opt_state, to_port, net, optimizer) -> Dict[str, Any]:
        return adam_state_from_jax(opt_state, lambda tree: to_port({"params": tree}),
                                   list(net.named_parameters()),
                                   optimizer.state_dict()["param_groups"])

    def save(self, epoch: int, current_iter: int) -> None:
        """models/net_{g,d}_{tag}.{pth,msgpack} and training_states/{tag}.state, tag =
        current_iter or `latest` for -1 (with the orbax backend the .pth and
        one DCP step). The state records the resolved step, so a resume from
        latest.state continues at the true iteration."""
        if not mesh.is_main_process():
            return  # the state is replicated: rank 0 writes it
        tag = "latest" if current_iter == -1 else str(current_iter)
        models = self.opt["path"]["models"]
        os.makedirs(models, exist_ok=True)
        for net, tensors in self.network_checkpoints().items():
            torch.save(_to_cpu(tensors), os.path.join(models, f"net_{net}_{tag}.pth"))
        step = int(current_iter) if current_iter >= 0 else self.step
        if self._ckpt_backend == "orbax":
            return self._save_orbax(epoch, step)
        for net, variables in self.jax_network_checkpoints().items():
            save_pytree(os.path.join(models, f"net_{net}_{tag}.msgpack"), variables)
        save_state(os.path.join(self.opt["path"]["training_states"], f"{tag}.state"),
                   {"epoch": int(epoch), "iter": step, "state": _to_cpu(self.train_state())})

    def _orbax_io(self):
        if self._orbax is None:
            from ..utils.orbax_io import OrbaxCheckpointIO

            train_opt = self.opt.get("train") or {}
            self._orbax = OrbaxCheckpointIO(
                os.path.join(self.opt["path"]["training_states"], "orbax"),
                async_save=bool(train_opt.get("async_checkpoint", True)))
        return self._orbax

    def _save_orbax(self, epoch: int, step: int) -> None:
        """One self-contained DCP step (state and nets), written in the
        background; skipped when `step` is the latest committed one (the
        final save right after a periodic save at the same step)."""
        io = self._orbax_io()
        if io.latest_step() != step:
            io.save(step, {"epoch": int(epoch), "iter": step, "state": self.train_state(),
                           "nets": self.network_checkpoints()})

    def finish_checkpoints(self) -> None:
        """Drain the DCP write in flight; a failed write raises here."""
        if self._orbax is not None:
            self._orbax.wait()

    def resume_training(self, state_path: str) -> Dict[str, int]:
        """Resume from the port's .state or the JAX package's, or from a DCP
        step (`orbax:<step>`, as find_resume_state names it)."""
        if state_path == "orbax" or state_path.startswith("orbax:"):
            step = state_path.partition(":")[2]
            restored = self._orbax_io().restore(int(step) if step else None)
            if restored is None:
                raise FileNotFoundError(f"no committed checkpoint under {self._orbax_io().root}")
            payload = restored[1]
            self.load_train_state(_int_opt_keys(payload["state"]))
            return {"epoch": int(payload["epoch"]), "iter": int(payload["iter"])}
        fmt, blob = read_state(state_path)
        state = blob["state"]
        if fmt == "msgpack":
            self.logger.info(f"{state_path}: a JAX-package training state")
            state = self.train_state_from_jax(state)
        self.load_train_state(state)
        return {"epoch": jax_step(blob["epoch"]), "iter": jax_step(blob["iter"])}

    def micro_batches(self, rows) -> List[torch.Tensor]:
        """A train array of k * b rows (k = accum_steps) -> k micro-batches
        of b rows on the device: the JAX package's `_shard_train_array`
        [k, b] stack, with its ValueError for a row count k does not divide."""
        x = np.asarray(rows)
        k = self.accum_steps
        if x.shape[0] % k:
            raise ValueError(f"train batch of {x.shape[0]} rows is not divisible by "
                             f"accum_steps={k}")
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return list(x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:])).unbind(0))

    def band(self, x: torch.Tensor, dim: int = 1, factor: int = 1, least: int = 1,
             what: str = "image") -> torch.Tensor:
        """This rank's row band of x along `dim` (x itself without a layout).
        Raises ValueError when the rows do not make S bands that divide by
        `factor` and hold at least `least` rows each (what the network that
        takes them needs)."""
        if self.space is None:
            return x
        rows, s = x.shape[dim], self.space.space_size
        if rows % (s * factor) or rows // s < least:
            raise ValueError(
                f"spatial_shards={s}: the {what}'s {rows} rows do not split into {s} bands "
                f"whose rows divide by {factor} and number at least {least}")
        r0, r1 = self.space.band(rows)
        return x.narrow(dim, r0, r1 - r0)

    def _place_net(self, net: torch.nn.Module) -> torch.nn.Module:
        """Load the configured weights into `net` (built on the CPU) and move
        it to the eval device in the compute dtype."""
        state = self.load_pretrained()
        if state is not None:
            net.load_state_dict(state)
        return net.to(device=self.device, dtype=self.dtype).eval()

    # -- eval forward ----------------------------------------------------------

    def _prep_lr(self, lr_np: np.ndarray) -> np.ndarray:
        return lr_np

    def eval_net(self) -> torch.nn.Module:
        """The network validation and test run (the EMA one when training)."""
        return self.net_g

    @torch.inference_mode()
    def eval_outputs(self, batch: Dict[str, Any]) -> torch.Tensor:
        """uint8 [B, 32, 32, T*C] -> uint8 [B, H, W, 3] on the eval device.
        On a row-band layout each rank of the group runs its band and the
        uint8 rows are gathered."""
        lr = torch.from_numpy(np.ascontiguousarray(self._prep_lr(np.asarray(batch["lr"]))))
        with _precision(self.matmul_precision):
            x = (lr.to(self.device).float() / 255.0).to(self.dtype)
            net = self.eval_net()
            if self.space is None:
                out = net(x)
            else:
                factor, least = net.band_rows
                out = net.forward_band(self.band(x, x.dim() - 3, factor, least, "LR input"),
                                       self.space)
            if out.dim() == 5:  # [B, 1, H, W, C] from SRCNN/HighResNet
                out = out[:, 0]
            return gather_rows(to_uint8(out), self.space)

    # -- validation (reference nondist_validation pattern) ---------------------

    def _metrics2run(self, dataset_name: str) -> Optional[Dict[str, Any]]:
        section = "test" if dataset_name == "test" else "val"
        return (self.opt.get(section) or {}).get("metrics")

    def validation(self, loader, current_iter, tb_logger=None, save_img: bool = False,
                   dataset_name: Optional[str] = None) -> Dict[str, float]:
        """One pass over `loader`: outputs, metrics against `hr`, optional
        pngs; returns {metric[tag]: average}. `tb_logger` is accepted for the
        JAX signature; the port has no TensorBoard sink yet."""
        from ..metrics import metric_tower_pretrained
        from ..metrics.fast_eval import fast_metric_fn

        dataset_name = dataset_name or loader.dataset.opt.get("name", "validation")
        metrics2run = self._metrics2run(dataset_name)
        section = self.opt.get("test" if dataset_name == "test" else "val") or {}
        fast_fns = {}
        if metrics2run and section.get("fast_metrics"):
            for name, m_opt in metrics2run.items():
                fn = fast_metric_fn(m_opt)
                if fn is not None:
                    fast_fns[name] = fn
        self._metric_tags = {}
        if metrics2run:
            for name, m_opt in metrics2run.items():
                try:
                    pretrained = metric_tower_pretrained(m_opt)
                except Exception:  # a bad weights file: every sample's metric fails below
                    pretrained = None
                self._metric_tags[name] = "(untrained-tower)" if pretrained is False else ""
            if dataset_name not in self.best_metric_results:
                rec = {}
                for metric, content in metrics2run.items():
                    better = content.get("better", "higher")
                    rec[metric] = {"better": better, "iter": -1,
                                   "val": float("-inf") if better == "higher" else float("inf")}
                self.best_metric_results[dataset_name] = rec
            self.metric_results = {m: 0.0 for m in metrics2run}

        # on a row-band layout every rank of a space group holds the same
        # gathered images: one rank a group counts each of them
        owner = self.space is None or self.space.space_index == 0
        count = 0
        metric_ok: Dict[str, int] = {}
        metric_fail: Dict[str, int] = {}
        metric_seconds = dict.fromkeys(metrics2run or {}, 0.0)
        t = dict.fromkeys(("data", "forward", "metrics", "writes"), 0.0)
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t["data"] += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            sr_dev = self.eval_outputs(batch)
            sr_uint8 = sr_dev.cpu().numpy()  # [B, H, W, 3]
            t["forward"] += time.perf_counter() - t0
            gt = batch.get("hr")
            # padding rows of a sharded loader are invalid; `index` is global
            valid = batch.get("valid")
            if valid is None:
                valid = np.ones((sr_uint8.shape[0],), bool)
            if not owner:  # the group's space index 0 counts, scores and writes
                continue
            indices = batch.get("index")
            if gt is not None and fast_fns:
                t0 = time.perf_counter()
                gt_dev = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
                mask = torch.as_tensor(valid, dtype=torch.float32, device=self.device)
                for name, fn in fast_fns.items():
                    self.metric_results[name] += float(torch.sum(fn(sr_dev, gt_dev) * mask))
                t["metrics"] += time.perf_counter() - t0
            for b in range(sr_uint8.shape[0]):
                if not valid[b]:
                    continue
                img_name = str(int(indices[b])) if indices is not None else str(count)
                sr_img = sr_uint8[b]
                t0 = time.perf_counter()
                if save_img:
                    if self.opt.get("is_train"):
                        path = os.path.join(self.opt["path"]["visualization"], img_name,
                                            f"{img_name}_{current_iter}.png")
                    else:
                        path = os.path.join(self.opt["path"]["visualization"], dataset_name,
                                            f"{img_name}_{self.opt['name']}.png")
                    write_png(path, sr_img)
                if gt is not None and metrics2run:
                    gt_img = np.asarray(gt[b])
                    if save_img and not self.opt.get("is_train"):
                        path = os.path.join(self.opt["path"]["visualization"], dataset_name,
                                            f"{img_name}_{self.opt['name']}_gt.png")
                        write_png(path, gt_img)
                    t1 = time.perf_counter()
                    t["writes"] += t1 - t0
                    data = {"img": sr_img, "img2": gt_img}
                    for name, m_opt in metrics2run.items():
                        if name in fast_fns:
                            continue  # already accumulated on the device
                        t2 = time.perf_counter()
                        try:
                            with _precision(self.matmul_precision):
                                value = calculate_metric(data, m_opt, device=self.device)
                            self.metric_results[name] += value
                            metric_ok[name] = metric_ok.get(name, 0) + 1
                        except Exception as e:  # one image's metric failing is counted, not fatal
                            metric_fail[name] = metric_fail.get(name, 0) + 1
                            self.logger.warning(f"metric {name} failed: {e}")
                        metric_seconds[name] += time.perf_counter() - t2
                    t["metrics"] += time.perf_counter() - t1
                else:
                    t["writes"] += time.perf_counter() - t0
                count += 1

        # device-batched metrics raise instead of being caught per sample;
        # reaching here means they succeeded on every valid sample
        if metrics2run and owner:
            for name in fast_fns:
                metric_ok[name] = count

        if metrics2run and mesh.world_size() > 1:
            # sum each rank's accumulators and counts before averaging (the
            # reference's dist_validation), laid out over sorted(metrics2run),
            # the same on every rank: a metric that failed on one rank's whole
            # shard must not misalign the vector, and the drop below is
            # decided on the global ok/fail counts
            names = sorted(metrics2run)
            k = len(names)
            total = mesh.sum_across_processes(
                [count] + [self.metric_results.get(m, 0.0) for m in names]
                + [metric_ok.get(m, 0) for m in names] + [metric_fail.get(m, 0) for m in names])
            count = int(total[0])
            for i, m in enumerate(names):
                self.metric_results[m] = float(total[1 + i])
                metric_ok[m] = int(total[1 + k + i])
                metric_fail[m] = int(total[1 + 2 * k + i])

        # a metric that failed on EVERY sample must not surface as a 0.0 average
        for name in list(self.metric_results):
            if metric_fail.get(name) and not metric_ok.get(name):
                self.logger.error(f"metric {name} failed on all samples "
                                  f"({metric_fail[name]} errors) — dropped from results")
                del self.metric_results[name]

        if metrics2run and count:
            for metric in self.metric_results:
                # average over the samples the metric succeeded on
                self.metric_results[metric] /= metric_ok.get(metric) or count
                rec = self.best_metric_results[dataset_name][metric]
                val = self.metric_results[metric]
                if (rec["better"] == "higher" and val >= rec["val"]) or (
                        rec["better"] == "lower" and val <= rec["val"]):
                    rec["val"], rec["iter"] = val, current_iter
            self._log_validation_metrics(current_iter, dataset_name)
        self.timings = {**t, "images": count, "metric_seconds": metric_seconds,
                        "metric_fail": metric_fail}
        self.logger.info(
            f"Validation [{dataset_name}] time: " + ", ".join(
                f"{k} {v:.3f} s" for k, v in t.items()) + f" over {count} images",
            extra={"timings": dict(self.timings)})
        return {m + self._metric_tags.get(m, ""): v for m, v in self.metric_results.items()}

    def _log_validation_metrics(self, current_iter, dataset_name):
        # machine-readable validation history rides metrics.jsonl (rows carry
        # a val_dataset key)
        log_dir = (self.opt.get("path") or {}).get("log")
        if log_dir and mesh.is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({
                    "iter": current_iter if isinstance(current_iter, int) else str(current_iter),
                    "val_dataset": dataset_name,
                    **{m: float(v) for m, v in self.metric_results.items()},
                }) + "\n")
        msg = f"Validation [{dataset_name}]\n"
        for metric, value in self.metric_results.items():
            rec = self.best_metric_results[dataset_name][metric]
            tag = self._metric_tags.get(metric, "")
            msg += f"\t # {metric}{tag}: {value:.4f}\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
        self.logger.info(msg)
