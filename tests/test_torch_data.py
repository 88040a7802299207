"""The port's S2-NAIP dataset and eval loader against the JAX package's.

On one synthetic tree, every sample of satlas_sr_tpu_torch.data.S2NAIPDataset
must be np.array_equal to the JAX package's (same keys, same Index/Chip): a
NAIP chip with a black pixel (skip and advance, the last one wrapping to
index 0), a missing band file (zero-filled), a band whose frame count
differs from tci's and a chip with too few frames (both skipped), black S2
frames (good-first frame choice), s2_bands (tci forced first),
old_naip_path, rand_crop, use_3d, train_samples and the epoch / explicit
salts of the per-item RNG. SequentialEvalLoader batches (index, valid,
padding and every array) must equal the JAX loader's for world 1 and for
ranks 0 and 1 of world 2.
"""

import numpy as np
import pytest

from satlas_sr_tpu.data import SequentialEvalLoader as JaxLoader
from satlas_sr_tpu.data import build_dataset as jax_build_dataset
from satlas_sr_tpu.utils.imgio import write_png
from satlas_sr_tpu_torch.data import SequentialEvalLoader, build_dataset
from torch_threads import two_torch_threads  # noqa: F401

N_CHIPS, FRAMES = 9, 5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2naip")
    rng = np.random.RandomState(5)
    for c in range(N_CHIPS):
        chip = f"{100 + c}_{200 + c}"
        naip = (rng.rand(128, 128, 3) * 254 + 1).astype(np.uint8)
        if c in (2, N_CHIPS - 1):
            naip[9, 3] = 0  # black NAIP pixel: skipped; the last wraps to index 0
        write_png(str(root / "naip" / chip / f"{chip}.png"), naip)
        write_png(str(root / "old_naip" / "2016" / f"{chip}.png"),
                  (rng.rand(128, 128, 3) * 255).astype(np.uint8))
        frames = 2 if c == 5 else FRAMES  # chip 5: too few frames
        tci = (rng.rand(frames * 32, 32, 3) * 254 + 1).astype(np.uint8)
        tci[32 * (c % frames):32 * (c % frames) + 4, :, :] = 0  # one black frame
        write_png(str(root / "sentinel2" / chip / "tci.png"), tci)
        for band in ("b08", "b11"):
            if band == "b11" and c == 4:
                continue  # missing band: zero-filled
            n = FRAMES + 1 if (band == "b08" and c == 6) else frames  # chip 6: mismatch
            write_png(str(root / "sentinel2" / chip / f"{band}.png"),
                      (rng.rand(n * 32, 32, 1) * 255).astype(np.uint8))
    return root


def _opt(tree, **extra):
    opt = {"type": "S2NAIPDataset", "name": "t", "phase": "test", "scale": 4,
           "sentinel2_path": str(tree / "sentinel2"), "naip_path": str(tree / "naip"),
           "n_s2_images": 3}
    opt.update(extra)
    return opt


CASES = {
    "tci": {},
    "bands": {"s2_bands": ["b08", "tci", "b11"]},
    "old_naip": {"old_naip_path": "OLD"},
    "rand_crop": {"rand_crop": True, "seed": 9},
    "use_3d": {"use_3d": True, "s2_bands": ["tci", "b08"]},
    "train_samples": {"phase": "train", "train_samples": 6, "seed": 4, "type": "SSRDataset"},
}


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("case", sorted(CASES))
def test_samples_equal_jax(tree, case):
    extra = dict(CASES[case])
    if extra.get("old_naip_path"):
        extra["old_naip_path"] = str(tree / "old_naip")
    port, ref = build_dataset(_opt(tree, **extra)), jax_build_dataset(_opt(tree, **extra))
    assert len(port) == len(ref) == (6 if case == "train_samples" else N_CHIPS)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            _assert_same_sample(port[i], ref[i])
    for i, salt in ((0, 17), (len(ref) - 1, 2)):
        _assert_same_sample(port.sample(i, salt), ref.sample(i, salt))


def test_skip_and_advance(tree):
    ds = build_dataset(_opt(tree, s2_bands=["tci", "b08"]))
    chips = [ds[i]["Chip"] for i in range(len(ds))]
    # chip 2: black NAIP -> 3; chip 6 (b08 frame count) -> 7; chip 8: black
    # NAIP -> wraps to 0. The advance grows with the attempts (index +=
    # counter, as the reference does): chip 5 (2 frames) -> 6 -> 8 -> 0.
    assert chips[2] == chips[3] and chips[6] == chips[7] and chips[5] == chips[0]
    assert chips[-1] == chips[0] and ds[-1 + len(ds)]["Index"] == 0
    assert ds[4]["lr"].shape == (32, 32, 3 * 4)  # tci + b08 per frame, 3 frames


def test_every_sample_invalid_raises(tree, tmp_path):
    write_png(str(tmp_path / "naip" / "x" / "x.png"), np.zeros((128, 128, 3), np.uint8))
    (tmp_path / "sentinel2").mkdir()
    ds = build_dataset(_opt(tree, naip_path=str(tmp_path / "naip"),
                            sentinel2_path=str(tmp_path / "sentinel2")))
    with pytest.raises(RuntimeError, match="no valid sample"):
        ds[0]


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("batch_size", [1, 4])
def test_eval_loader_batches_equal_jax(tree, world, rank, batch_size):
    opt = _opt(tree, s2_bands=["tci", "b08"])
    port = SequentialEvalLoader(build_dataset(opt), batch_size=batch_size, rank=rank, world=world)
    ref = JaxLoader(jax_build_dataset(opt), batch_size=batch_size, rank=rank, world=world)
    got, want = list(port), list(ref)
    assert len(port) == len(ref) == len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_sample(g, w)
    valid = np.concatenate([b["valid"] for b in got])
    index = np.concatenate([b["index"] for b in got])
    assert list(index[valid]) == list(range(rank, N_CHIPS, world))
    assert (~valid).sum() == len(valid) - len(range(rank, N_CHIPS, world))
