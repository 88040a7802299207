"""Evaluation-with-GT CLI on one card.

`python -m satlas_sr_tpu_torch.test -opt <yml>` does what
`python -m satlas_sr_tpu.test` does (ssr/test.py's test_pipeline): parse the
options (is_train=False), build one ordered loader per `test_datasets`
entry, build the model, and run model.validation per loader, computing the
configured metrics (PSNR, SSIM, cPSNR on the host; LPIPS and CLIPScore on
the model's device) against the NAIP ground truth and saving visualization
pngs under results/<name>/visualization/<dataset>/. It writes
results/<name>/results.json and metrics.jsonl rows.

With `--launcher` (torchrun's env://; `--device cpu` runs gloo ranks) each
rank evaluates its round-robin shard of every test set and writes its own
chips' pngs; the metric sums and counts are summed across the ranks before
averaging (models/base.py), and rank 0 writes the log, metrics.jsonl and
results.json.
"""

from __future__ import annotations

import json
import os
import time

from .data import SequentialEvalLoader, build_dataset
from .device import resolve_device
from .models import build_model
from .parallel.mesh import data_coords, is_main_process
from .utils.logger import get_root_logger
from .utils.options import close_distributed, dict2str, make_exp_dirs, parse_options


def test_pipeline(root_path: str, argv=None, device="cuda") -> dict:
    opt, args = parse_options(root_path, is_train=False, argv=argv, device=device)
    device = resolve_device(args.device)
    make_exp_dirs(opt)
    log_file = os.path.join(opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file if is_main_process() else None)
    logger.info(dict2str(opt))

    # a row-band layout (spatial_shards): the ranks of a space group take the
    # same images, each running its band (models/base.py, "Row bands")
    group, groups = data_coords(int(opt.get("spatial_shards", 1) or 1))
    loaders = []
    for _, dataset_opt in sorted((opt.get("test_datasets") or {}).items()):
        test_set = build_dataset(dataset_opt)
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")
        loaders.append(SequentialEvalLoader(
            test_set, batch_size=int(dataset_opt.get("batch_size", 1)), rank=group, world=groups))

    model = build_model(opt, device=device)
    results = {}
    for loader in loaders:
        name = loader.dataset.opt.get("name", "test")
        logger.info(f"Testing {name}...")
        results[name] = model.validation(
            loader, current_iter=opt["name"], tb_logger=None,
            save_img=bool((opt.get("test") or {}).get("save_img", False)),
            dataset_name=name,
        )

    # one machine-readable summary per run (metric rows also stream into
    # metrics.jsonl); the reference only prints averages to the log
    path_opt = opt.get("path") or {}
    summary = {
        "name": opt["name"],
        "weights": path_opt.get("pretrain_network_g"),
        "param_key_g": path_opt.get("param_key_g", "params_ema"),
        "results": {ds: {m: float(v) for m, v in r.items()} for ds, r in results.items()},
        "timestamp": int(time.time()),
    }
    if is_main_process():
        out_path = os.path.join(path_opt["results_root"], "results.json")
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
        logger.info(f"Results summary written to {out_path}")
    return results


def main(argv=None, device="cuda"):
    root_path = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
    try:
        return test_pipeline(root_path, argv, device=device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()
