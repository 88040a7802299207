"""The port's bf16-against-f32 training verdict
(satlas_sr_tpu_torch/dtype_train_equiv.py `equivalence_verdict`) equals the
JAX package's scripts/dtype_train_equiv.py on the five cases of
tests/test_dtype_equiv_gate.py: within the bar, over the bar, a NaN loss
with matching val rows, an error section, missing val rows."""

import importlib.util
import os
import sys

import pytest

from satlas_sr_tpu_torch import dtype_train_equiv as dte
from torch_threads import two_torch_threads  # noqa: F401

SCRIPTS = os.path.join(os.path.dirname(__file__), os.pardir, "scripts")
sys.path.insert(0, SCRIPTS)  # the JAX script imports its sibling train_evidence
_SPEC = importlib.util.spec_from_file_location("jax_dtype_train_equiv",
                                               os.path.join(SCRIPTS, "dtype_train_equiv.py"))
jax_dte = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_dte)


def _section(psnr_last, finite=True, steady=0.1):
    return {"loss_finite": finite, "steady_iter_seconds": steady,
            "val_psnr": [{"iter": 150, "psnr": psnr_last - 0.01},
                         {"iter": 300, "psnr": psnr_last}]}


CASES = {
    "within_bar": ({"float32": _section(20.50, steady=0.14),
                    "bfloat16": _section(20.52, steady=0.10)}, (True, 0.02, 1.4)),
    "over_bar": ({"float32": _section(20.50), "bfloat16": _section(20.60)}, (False, 0.10, 1.0)),
    "nan_loss": ({"float32": _section(5.635, finite=False), "bfloat16": _section(5.635)},
                 (False, None, None)),
    "error": ({"float32": {"error": "train CLI exited 1"}, "bfloat16": _section(20.5)},
              (False, None, None)),
    "no_val_rows": ({"float32": dict(_section(20.5), val_psnr=[]), "bfloat16": _section(20.5)},
                    (False, None, 1.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_equivalence_verdict_equals_jax(case):
    sections, (ok, delta, speedup) = CASES[case]
    got = dte.equivalence_verdict(sections, bar=0.05)
    assert got == jax_dte.equivalence_verdict(sections, bar=0.05)
    assert got[0] is ok
    for value, expected in ((got[1], delta), (got[2], speedup)):
        assert value is None if expected is None else abs(value - expected) < 1e-9
