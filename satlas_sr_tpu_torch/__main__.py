"""`python -m satlas_sr_tpu_torch`: list the port's entry points."""

import sys

CLIS = [
    ("train", "train a model (-opt cfg.yml [--auto_resume])"),
    ("test", "evaluate with GT + metric suite (-opt cfg.yml)"),
    ("infer", "GT-free batch inference (-opt cfg.yml; s2_bands for multi-band)"),
    ("infer_grid", "tile-grid inference + stitch (whole_tile / halo modes)"),
    ("serve", "HTTP serving daemon with micro-batching on the card"),
    ("export", "export a .ssrx artifact of torch.export programs"),
    ("acceptance", "PSNR-parity acceptance vs a released checkpoint (PARITY_RESULTS.json)"),
    ("doctor", "preflight: config lint, paths, towers, the card and the kernel build"),
    ("warmup", "build the config's kernels and run each of its programs once"),
    ("profile", "torch.profiler trace of a config's program: top kernels, idle share"),
    ("ckpt", "inspect and verify a .pth or .state checkpoint"),
    ("scan_data", "validate an S2-NAIP tree with the dataset's own skip rules"),
    ("fetch", "list / download the S2-NAIP data and released weights"),
    ("tune", "rank (batch, remat, accum_steps) train candidates by samples/s on the card"),
    ("prepare", "raw rasters -> S2-NAIP tree chips (reproject needs rasterio)"),
    ("tower_dryrun", "classify a directory of tower weights (vgg19, lpips, CLIP) in one pass"),
    ("train_evidence", "300+ iterations of both trainer families, preempted and resumed: "
                       "does val PSNR rise"),
    ("dtype_train_equiv", "the same train run in float32 and bfloat16: final val-PSNR delta, "
                          "speedup"),
    ("band_order_search", "rank s2_bands orders of a multi-band .pth by val PSNR"),
    ("convert_checkpoint", "JAX .msgpack <-> reference .pth (to_pth | from_pth)"),
]


def main() -> int:
    print("satlas_sr_tpu_torch: satellite-imagery super-resolution on an NVIDIA card "
          "(PyTorch + CUDA)\n")
    width = max(len(n) for n, _ in CLIS)
    for name, desc in CLIS:
        print(f"  python -m satlas_sr_tpu_torch.{name:<{width}}  {desc}")
    print("\nThose that touch a device run on the card and raise without one; each takes "
          "--device cpu (train and test from Python: device='cpu'). prepare is host only.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
