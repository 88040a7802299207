"""The port's config lint (satlas_sr_tpu_torch/utils/lint.py) against the JAX
package's: the same warnings, in the same order, on every shipped options
yml read as a train and as an infer config, and on misspelt keys and bad
values. Both are pure Python; equality is exact."""

import copy
import glob
import os

import pytest
import yaml

from satlas_sr_tpu.utils.lint import lint_options as jax_lint
from satlas_sr_tpu_torch.utils.lint import lint_options, report_lint
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
OPTIONS = sorted(glob.glob(os.path.join(ROOT, "options", "**", "*.yml"), recursive=True))


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("path", OPTIONS, ids=[os.path.relpath(p, ROOT) for p in OPTIONS])
def test_lint_matches_jax_on_shipped_configs(path, kind):
    opt = _load(path)
    assert lint_options(opt, kind) == jax_lint(opt, kind)


def _misspell(opt, keys, new):
    node = opt
    for k in keys[:-1]:
        node = node[k]
    node[new] = node.pop(keys[-1])


TYPOS = [
    ("train", ("train", "ema_decay"), "ema_decy"),
    ("train", ("network_g", "num_block"), "num_blocks"),
    ("train", ("datasets", "train", "n_s2_images"), "n_s2_image"),
    ("train", ("val", "metrics", "psnr", "crop_border"), "crop_boarder"),
    ("infer", ("batch_size",), "batchsize"),
    ("infer", ("path", "pretrain_network_g"), "pretrain_netwrok_g"),
]


@pytest.mark.parametrize("kind,keys,new", TYPOS, ids=[t[2] for t in TYPOS])
def test_lint_matches_jax_on_misspelt_keys(kind, keys, new):
    name = "esrgan_s2naip_urban.yml" if kind == "train" else "infer_example.yml"
    opt = _load(os.path.join(ROOT, "options", name))
    _misspell(opt, keys, new)
    got = lint_options(copy.deepcopy(opt), kind)
    assert got == jax_lint(opt, kind)
    assert len(got) == 1 and new in got[0] and "did you mean" in got[0]


def test_lint_matches_jax_on_bad_values(capsys):
    opt = _load(os.path.join(ROOT, "options", "infer_example.yml"))
    opt["compute_dtype"] = "bfloat61"
    opt["network_g"]["type"] = "RRDBNetx"
    got = report_lint(opt, "infer")
    assert got == jax_lint(opt, "infer") and len(got) == 2
    assert capsys.readouterr().out.count("[config lint] WARNING") == 2
