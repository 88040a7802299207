"""S2-NAIP dataset: Sentinel-2 time series paired with NAIP chips.

A copy of the JAX package's `data/s2naip.py` (numpy, no JAX), on the port's
own `utils/imgio` and `utils/infer_utils.select_frames`. Its behaviour
follows the reference S2NAIPDataset (ssr/data/s2-naip_dataset.py:34-249):
- chip discovery from `naip_path/**/*.png` (chip id = parent dir)
- per-band Sentinel-2 png loading (`sentinel2/{chip}/{band}.png`), band list
  defaults to ['tci'] with tci forced first; flat [T*32, 32, C] pngs reshaped
  to frames; missing bands zero-filled
- skip-and-advance rejection of invalid samples: NAIP chips containing black
  pixels (channel-sum == 0), unreadable band files, chips with fewer than
  n_s2_images frames
- good/bad frame partition on the tci channel-sum test, good-first sampling
- rand_crop augmentation: random LR size in [24, 32], top-left crop, resize
  back (nearest) to 32/128
- optional old-NAIP high-res conditioning image and OSM-object filtering
- train_samples subsampling; tile-weight sampler weights

Differences from the reference (deliberate, as in the JAX package):
- Deterministic where seeded: every item derives its RNG from
  (seed, salt, index), salt = the epoch or an explicit draw ordinal
  (the reference uses process-global `random`, s2-naip_dataset.py:16).
- Returns numpy HWC uint8; normalisation (/255) happens on the device.
- A corrupt NAIP or old-NAIP png is skipped like any other bad chip, and the
  skip-and-advance loop fails loudly instead of spinning forever.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional  # noqa: F401

import numpy as np

from ..registry import DATASET_REGISTRY
from ..utils.imgio import read_png
from ..utils.infer_utils import select_frames


def has_black_pixels(img_hwc: np.ndarray) -> bool:
    """True if any pixel has channel-sum zero (ssr/utils/data_utils.py:3-10)."""
    return bool((img_hwc.astype(np.int64).sum(axis=-1) == 0).any())


def _resize_nearest_np(img: np.ndarray, out_hw) -> np.ndarray:
    """Host-side nearest-neighbor resize, uint8 in/out.

    The reference's rand_crop path calls torch F.interpolate with its DEFAULT
    mode='nearest' (s2-naip_dataset.py:234); nearest is required for parity —
    do not "upgrade" this to bilinear.
    """
    ih, iw = img.shape[:2]
    oh, ow = out_hw
    ys = (np.arange(oh) * (ih / oh)).astype(np.int64)
    xs = (np.arange(ow) * (iw / ow)).astype(np.int64)
    return img[ys][:, xs]


@DATASET_REGISTRY.register("S2NAIPDataset")
class S2NAIPDataset:
    """Map-style dataset yielding dict samples (numpy uint8, HWC).

    Also registered under the alias ``SSRDataset`` (below): three reference
    configs (allbands_*/old-naip_*/rand_crop_*) declare that type, which is
    registered nowhere in the reference and crashes there (SURVEY.md §5.6);
    here those configs run verbatim.
    """

    def __init__(self, opt: Dict[str, Any]):
        self.opt = opt
        self.split = opt.get("phase", "train")
        train = self.split == "train"
        self.rand_crop = bool(opt.get("rand_crop", False))
        self.n_s2_images = int(opt["n_s2_images"])
        self.scale = int(opt.get("scale", 4))
        self.use_3d = bool(opt.get("use_3d", False))

        def _path(v):
            return os.path.expanduser(v) if isinstance(v, str) else v

        self.old_naip_path = _path(opt.get("old_naip_path"))
        self.osm_chips_to_masks = _path(opt.get("osm_objs_path"))
        self.seed = int(opt.get("seed", 123))

        bands = list(opt.get("s2_bands") or ["tci"])
        bands.insert(0, bands.pop(bands.index("tci")))
        self.s2_bands = bands

        self.s2_path = _path(opt["sentinel2_path"])
        self.naip_path = _path(opt["naip_path"])
        if not (os.path.exists(self.s2_path) and os.path.exists(self.naip_path)):
            raise FileNotFoundError(
                "Please make sure the paths to the data directories are correct."
            )

        old_naip_chips: Dict[str, List[str]] = {}
        if self.old_naip_path:
            for old_naip in glob.glob(self.old_naip_path + "/**/*.png", recursive=True):
                chip = os.path.basename(old_naip)[:-4]
                old_naip_chips.setdefault(chip, []).append(old_naip)

        osm_obj_data = None
        if self.osm_chips_to_masks and train:
            with open(self.osm_chips_to_masks) as f:
                osm_obj_data = json.load(f)
            print(f"Loaded osm_chip_to_masks.json with {len(osm_obj_data)} entries.")
        self.osm_obj_data = osm_obj_data

        naip_chips = sorted(glob.glob(self.naip_path + "/**/*.png", recursive=True))
        if "train_samples" in opt and train:
            rng = np.random.RandomState(self.seed)
            idx = rng.choice(len(naip_chips), size=int(opt["train_samples"]), replace=False)
            naip_chips = [naip_chips[i] for i in sorted(idx)]

        self.datapoints: List[tuple] = []
        for n in naip_chips:
            chip = os.path.basename(os.path.dirname(n))
            if osm_obj_data is not None:
                objs = osm_obj_data.get(chip)
                if not objs or sum(len(v) for v in objs.values()) < int(opt["n_osm_objs"]):
                    continue
            s2_paths = [os.path.join(self.s2_path, chip, band + ".png") for band in self.s2_bands]
            old_chip = old_naip_chips[chip][0] if self.old_naip_path else None
            self.datapoints.append((n, s2_paths, chip, old_chip))

        self.data_len = len(self.datapoints)
        self.epoch = 0
        print(f"Number of datapoints for split {self.split}: {self.data_len}")

    # -- sampling ------------------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _warn_unreadable(self, path: str) -> None:
        warned = getattr(self, "_warned_paths", None)
        if warned is None:
            warned = self._warned_paths = set()
        if path not in warned:  # once per path (benign race across workers)
            warned.add(path)
            print(f"WARNING: skipping unreadable png {path}", flush=True)

    def tile_weights_array(self, tile_weights: Dict[str, float]) -> np.ndarray:
        """Per-datapoint sampling weights from a chip->weight JSON mapping.

        Chips absent from the mapping get weight 1 (s2-naip_dataset.py:144-147).
        """
        weights = np.ones((self.data_len,), np.float64)
        for i, dp in enumerate(self.datapoints):
            chip = os.path.basename(dp[0])[:-4]
            if chip in tile_weights:
                weights[i] = tile_weights[chip]
        print(
            "Using tile_weight_sampler, min={} max={} mean={}".format(
                weights.min(), weights.max(), weights.mean()
            )
        )
        return weights

    # -- item loading --------------------------------------------------------

    def _rng_for(self, index: int, salt: Optional[int] = None) -> np.random.RandomState:
        salt = self.epoch if salt is None else salt
        return np.random.RandomState(
            (self.seed * 1_000_003 + salt * 10_007 + index) % (2**31 - 1)
        )

    def _load_bands(self, s2_paths: List[str]) -> Optional[np.ndarray]:
        """-> [T, 32, 32, C_total] uint8 or None on failure.

        Reference parity (s2-naip_dataset.py:184-199): a MISSING band file
        becomes zeros with exactly n_s2_images frames; the per-band stacks
        then concatenate on channels, which requires every band to carry the
        SAME frame count — any mismatch (a band png shorter/longer than tci,
        or a missing band next to a tci whose length != n_s2_images) raised
        out of the reference's torch.cat into its bare-except skip path, so
        here it returns None and the chip is skipped. Do not "repair" by
        truncating/padding: that would train on chips the reference drops.
        """
        per_band = []
        for i, path in enumerate(s2_paths):
            c = 3 if i == 0 else 1
            if not os.path.exists(path):
                per_band.append(np.zeros((self.n_s2_images, 32, 32, c), np.uint8))
                continue
            try:
                img = read_png(path)  # [T*32, 32, C]
            except Exception:
                return None
            if img.shape[0] % 32 != 0 or img.shape[1] != 32:
                return None
            per_band.append(img.reshape(-1, 32, 32, img.shape[-1]))
        n_frames = per_band[0].shape[0]
        if any(frames.shape[0] != n_frames for frames in per_band):
            return None
        return np.concatenate(per_band, axis=-1)

    def sample(self, index: int, salt: int) -> Dict[str, Any]:
        """Load an item with an explicit RNG salt.

        The prefetch loader assigns a deterministic draw ordinal as the salt
        (under its sequencer lock), so repeated visits to a chip resample
        frames/crops while the overall stream stays bit-reproducible no matter
        how worker threads interleave. Plain __getitem__ salts with the
        dataset-level epoch instead.
        """
        return self._load(index, salt)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self._load(index, None)

    def _load(self, index: int, salt: Optional[int]) -> Dict[str, Any]:
        counter = 0
        while True:
            if counter > 2 * self.data_len + 16:
                # beyond-reference guard: the reference's skip-and-advance
                # loop (s2-naip_dataset.py:157-203) spins FOREVER when every
                # sample is invalid (e.g. wrong frame geometry); fail loudly
                # after cycling the dataset instead
                raise RuntimeError(
                    f"no valid sample found after {counter} skip-and-advance "
                    f"attempts over {self.data_len} datapoints — every sample "
                    "has black pixels, missing bands, or non-32x32 frames")
            index += counter
            if index >= self.data_len:
                index = 0
            naip_path, s2_paths, chip, old_naip_path = self.datapoints[index]

            try:
                naip = read_png(naip_path)  # [128, 128, 3]
            except Exception:
                # beyond-reference robustness: the reference reads the NAIP
                # OUTSIDE its try/except (s2-naip_dataset.py:171), so one
                # corrupt png kills a run hours in. Skip it like every other
                # bad chip — no distribution divergence, since the reference
                # cannot run on such a tree at all. Warn once per path.
                self._warn_unreadable(naip_path)
                counter += 1
                continue
            if has_black_pixels(naip):
                counter += 1
                continue
            img_hr = naip

            s2 = self._load_bands(s2_paths)
            if s2 is None:
                counter += 1
                continue
            if s2.shape[0] < self.n_s2_images:
                counter += 1
                continue

            rng = self._rng_for(index, salt)
            tci = s2[..., :3]
            frame_is_bad = np.array([has_black_pixels(t) for t in tci])
            indices = select_frames(frame_is_bad, self.n_s2_images, rng)
            img_s2 = s2[indices]  # [T, 32, 32, C]

            if self.rand_crop:
                lr_size = int(rng.randint(24, 33))
                hr_size = lr_size * 4
                s2_crop = img_s2[:, :lr_size, :lr_size]
                hr_crop = img_hr[:hr_size, :hr_size]
                img_s2 = np.stack([_resize_nearest_np(f, (32, 32)) for f in s2_crop])
                img_hr = _resize_nearest_np(hr_crop, (128, 128))

            if not self.use_3d:
                # channel-stack frames: [32, 32, T*C] with frame-major ordering
                t, h, w, c = img_s2.shape
                img_s2 = np.concatenate(list(img_s2), axis=-1)

            sample = {
                "hr": img_hr,
                "lr": img_s2,
                "Index": index,
                "Phase": self.split,
                "Chip": chip,
            }
            if old_naip_path is not None:
                try:
                    sample["old_hr"] = read_png(old_naip_path)
                except Exception:  # same skip policy as the naip read above
                    self._warn_unreadable(old_naip_path)
                    counter += 1
                    continue
            return sample

    def __len__(self) -> int:
        return self.data_len


# Alias: the reference's allbands_*/old-naip_*/rand_crop_* configs declare
# `type: SSRDataset`, a name its registry never defines — those configs crash
# in the reference. Accept them here (SURVEY.md §5.6 known-bug list).
DATASET_REGISTRY.register("SSRDataset")(S2NAIPDataset)
