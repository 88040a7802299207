"""Training pipeline CLI (the JAX package's `train.py`).

`python -m satlas_sr_tpu_torch.train -opt options/esrgan_s2naip_urban.yml
 [--auto_resume] [--debug] [--force_yml a:b=c]` on the card; from Python,
`train_pipeline(root, argv, device="cpu")` runs it on the CPU.

Options -> resume-state discovery (the newest intact training_states/*.state)
-> experiment dirs (a fresh run archives an existing one) and loggers ->
datasets and loaders -> model -> the iteration loop: a prefetching loader
feeds `model.train_iter`, with the loss line every print_freq, checkpoints
every save_checkpoint_freq, validation every val_freq, and a final save and
validation. With `train.accum_steps` k the loader yields k x
batch_size_per_gpu rows an iteration and the epoch and resume bookkeeping
count those rows; the iteration, and so every cadence, is one optimizer
update. SIGTERM only sets a flag; the loop then saves a full state at the
next iteration boundary and returns, so --auto_resume continues from it.
`logger.profile` ({start_iter, num_iters, dir}) records a torch.profiler
trace of that window (rank 0's).

With `--launcher` the process is one rank of a data-parallel job (one card
a rank, or gloo processes with `--device cpu`): every rank takes rank 0's
fresh-or-resume decision, feeds its own rank-sharded rows (the epoch
counts all ranks' rows), and validates its shard of each val set; rank 0
alone logs to file, wandb and tb and writes checkpoints. A stop signal on
any rank stops every rank at the same iteration (`stop_requested`).
`train.checkpoint_backend: orbax` resumes from the newest committed
torch.distributed.checkpoint step (utils/orbax_io.py).

`spatial_shards: S` (S > 1, with --launcher and S dividing the ranks on a
host) splits every image's rows over S consecutive ranks (models/base.py,
"Row bands"): the ranks form world/S data groups, the loaders and the
sampler's seed (manual_seed + group) shard by data group, a group loads S x
batch_size_per_gpu rows an iteration (x accum_steps), so the global batch
is the JAX package's on as many devices, and each rank trains on its band.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

from .data import SequentialEvalLoader, build_dataset, build_train_loader
from .device import resolve_device
from .models import build_model
from .parallel import mesh
from .utils.checkpoint import verify_state_file
from .utils.logger import (AvgTimer, MessageLogger, get_root_logger, init_tb_logger,
                           init_wandb_logger)
from .utils.options import (close_distributed, copy_opt_file, dict2str, make_exp_dirs,
                            parse_options)


def find_resume_state(opt) -> Optional[str]:
    """The explicit `path.resume_state`, or with auto_resume the newest intact
    training_states/*.state (a torn one is skipped with a warning), or with
    the orbax backend `orbax:<newest committed step>`."""
    explicit = (opt.get("path") or {}).get("resume_state")
    if explicit:
        return explicit
    if not opt.get("auto_resume"):
        return None
    if str((opt.get("train") or {}).get("checkpoint_backend") or "native") == "orbax":
        from .utils.orbax_io import latest_committed_step

        step = latest_committed_step(os.path.join(opt["path"]["training_states"], "orbax"))
        return None if step is None else f"orbax:{step}"
    state_dir = opt["path"]["training_states"]
    if not os.path.isdir(state_dir):
        return None

    def key(f):
        stem = f[:-len(".state")]
        return int(stem) if stem.isdigit() else -1

    for fname in sorted((f for f in os.listdir(state_dir) if f.endswith(".state")),
                        key=key, reverse=True):
        path = os.path.join(state_dir, fname)
        if verify_state_file(path):
            return path
        get_root_logger().warning(f"auto_resume: skipping corrupted/partial state {path}")
    return None


def _broadcast_resume_decision(path: Optional[str]) -> Optional[str]:
    """Rank 0's fresh-or-resume decision on every rank. Ranks can see
    different files (a .state mid-write on one host, experiment dirs not
    shared): a rank deciding alone would skip make_exp_dirs' barrier that
    the others wait at, or start at another iteration and desync the
    step's collectives. A path another rank cannot read fails loudly there."""
    return mesh.broadcast_bytes((path or "").encode()).decode() or None


class StopPoll:
    """The collective stop decision of `world` ranks.

    Alone, the local SIGTERM flag decides at every iteration. Across ranks
    the flag is summed over all of them, so every rank leaves the (collective)
    step at the same iteration, whichever rank the signal reached. A poll is
    a blocking collective, so it runs on a cadence identical on every rank:
    the next poll comes after ~10 s of rank 0's measured step time (shipped
    in the poll), at least one and at most min(print_freq, 50) iterations
    later."""

    def __init__(self, stop_signals: list, world: int, print_freq: int):
        self.signals, self.world = stop_signals, world
        self.cap = max(1, min(int(print_freq), 50))
        self.next, self.last_t, self.last_it = 0, time.time(), 0

    def __call__(self, it: int) -> bool:
        if self.world <= 1:
            return bool(self.signals)
        if it < self.next:
            return False  # the local flag waits for the next poll
        now = time.time()
        secs = (now - self.last_t) / max(it - self.last_it, 1)
        rows = mesh.gather_across_processes([float(bool(self.signals)), secs])
        self.last_t, self.last_it = now, it
        r0_secs = max(float(rows[0, 1]), 1e-3)  # rank 0's, the same on every rank
        self.next = it + int(min(max(10.0 / r0_secs, 1), self.cap))
        return bool(rows[:, 0].sum())


def _start_profile():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def train_pipeline(root_path: str, argv=None, device="cuda") -> None:
    opt, args = parse_options(root_path, is_train=True, argv=argv, device=device)
    device = resolve_device(args.device)  # no card, no run: raise before touching the disk
    opt["root_path"] = root_path
    world = opt["world_size"]
    is_main = mesh.is_main_process()

    resume_state_path = find_resume_state(opt)
    if world > 1:
        resume_state_path = _broadcast_resume_decision(resume_state_path)
    make_exp_dirs(opt, archive_existing=resume_state_path is None)
    if is_main:
        copy_opt_file(args.opt, opt["path"]["experiments_root"])

    log_file = os.path.join(opt["path"]["log"], f"train_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file if is_main else None)
    logger.info(dict2str(opt))
    if is_main and "debug" not in opt["name"]:
        init_wandb_logger(opt)  # before tb, as the reference (sync_tensorboard)
    tb_logger = init_tb_logger(opt) if is_main else None

    train_ds_opt = opt["datasets"]["train"]
    train_set = build_dataset(train_ds_opt)
    # a row-band layout: the S ranks of a data group load the same rows, S x
    # batch_size_per_gpu of them (the JAX package's per-device batch), and
    # each trains on its band of every image
    spatial = int(opt.get("spatial_shards", 1) or 1)
    group, groups = mesh.data_coords(spatial)
    # gradient accumulation: an iteration takes accum_steps micro-batches, so
    # the loader yields k * b rows (the model splits them into k batches of b)
    accum = int((opt.get("train") or {}).get("accum_steps", 1) or 1)
    loader_ds_opt = {**train_ds_opt, "batch_size_per_gpu":
                     int(train_ds_opt.get("batch_size_per_gpu", 16)) * accum * spatial}
    val_loaders = [
        SequentialEvalLoader(build_dataset(ds_opt), batch_size=int(ds_opt.get("batch_size", 1)),
                             rank=group, world=groups)
        for phase, ds_opt in opt["datasets"].items() if phase != "train"]

    total_iters = int(opt["train"]["total_iter"])
    rows_per_iter = int(loader_ds_opt["batch_size_per_gpu"])  # k * b * S rows a data group
    # an iteration consumes every data group's rows
    iters_per_epoch = max(len(train_set) // (rows_per_iter * groups), 1)

    model = build_model(opt, device=device)
    start_iter = epoch = 0
    if resume_state_path:
        info = model.resume_training(resume_state_path)
        start_iter, epoch = info["iter"], info["epoch"]
        logger.info(f"Resuming training from epoch: {epoch}, iter: {start_iter}.")

    # built after the resume: the sampler and the draw salts fast-forward to
    # start_iter, so a resumed run sees the batches the uninterrupted one would
    train_loader = build_train_loader(train_set, loader_ds_opt,
                                      seed=int(opt["manual_seed"]) + group,
                                      rank=group, world_size=groups,
                                      start_sample=start_iter * rows_per_iter)
    msg_logger = MessageLogger(opt, start_iter, tb_logger)
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    logger.info(f"Start training from epoch: {epoch}, iter: {start_iter}")

    current_iter = start_iter
    val_opt = opt.get("val") or {}
    val_freq = int(val_opt.get("val_freq", 0) or 0)
    ckpt_freq = int(opt["logger"].get("save_checkpoint_freq", 5000))
    print_freq = int(opt["logger"].get("print_freq", 100))
    profile_opt = opt["logger"].get("profile") or {}
    profile_iters = int(profile_opt.get("num_iters", 0) or 0) if is_main else 0
    # the first iteration this run executes is start_iter + 1
    profile_trigger = max(int(profile_opt.get("start_iter", 0) or 0), start_iter + 1)
    profile_dir = profile_opt.get("dir", os.path.join(opt["path"]["log"], "profile"))
    profiler = None

    def validate():
        for val_loader in val_loaders:
            model.validation(val_loader, current_iter, tb_logger, bool(val_opt.get("save_img", False)),
                             dataset_name=val_loader.dataset.opt.get("name", "validation"))

    stop_signals: list = []
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, lambda signum, frame: stop_signals.append(signum))
    except ValueError:  # not the main thread
        prev_sigterm = None

    stop_requested = StopPoll(stop_signals, world, print_freq)
    preempted = False
    batches = iter(train_loader)
    try:
        while current_iter < total_iters:
            if stop_requested(current_iter):
                by = stop_signals[0] if stop_signals else "a peer rank"
                logger.warning(f"Stop signal ({by}) received: saving the training "
                               f"state at iter {current_iter} and exiting cleanly.")
                model.save(epoch, current_iter)
                preempted = True
                break
            batch = next(batches, None)
            if batch is None:  # a finite sampler ran out: the next epoch
                batches = iter(train_loader)
                continue
            data_timer.record()
            current_iter += 1
            epoch = current_iter // iters_per_epoch
            if profile_iters and current_iter == profile_trigger and profiler is None:
                profiler = _start_profile()
            model.train_iter(batch, current_iter)
            if profiler is not None and current_iter >= profile_trigger + profile_iters - 1:
                profiler.stop()
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(profile_dir, f"trace_{current_iter}.json"))
                profiler, profile_iters = None, 0
                logger.info(f"Profiler trace written to {profile_dir}")
            iter_timer.record()
            if current_iter == start_iter + 1:
                msg_logger.reset_start_time()
            if current_iter % print_freq == 0 and is_main:
                log_vars = {"epoch": epoch, "iter": current_iter,
                            "lrs": model.get_current_learning_rate(),
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time()}
                log_vars.update(model.log_dict)
                msg_logger(log_vars)
            if current_iter % ckpt_freq == 0:
                logger.info("Saving models and training states.")
                model.save(epoch, current_iter)
            if val_freq and current_iter % val_freq == 0:
                validate()
            data_timer.start()
            iter_timer.start()
    finally:
        train_loader.stop()
        msg_logger.close()
        if tb_logger is not None:
            tb_logger.close()
        if profiler is not None:
            profiler.stop()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    if preempted:
        model.finish_checkpoints()
        return
    logger.info("End of training. Saving the latest model.")
    model.save(epoch=-1, current_iter=-1)
    model.finish_checkpoints()
    if val_freq:
        validate()


def main(argv=None, device="cuda"):
    root_path = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
    try:
        train_pipeline(root_path, argv, device=device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()
