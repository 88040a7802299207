"""`python -m satlas_sr_tpu_torch`: list the port's entry points."""

import sys

CLIS = [
    ("train", "train a model (-opt cfg.yml [--auto_resume])"),
    ("test", "evaluate with GT + metric suite (-opt cfg.yml)"),
    ("infer", "GT-free batch inference (-opt cfg.yml; s2_bands for multi-band)"),
    ("infer_grid", "tile-grid inference + stitch (whole_tile / halo modes)"),
    ("serve", "HTTP serving daemon with micro-batching on the card"),
    ("export", "export a .ssrx artifact of torch.export programs"),
]


def main() -> int:
    print("satlas_sr_tpu_torch: satellite-imagery super-resolution on an NVIDIA card "
          "(PyTorch + CUDA)\n")
    width = max(len(n) for n, _ in CLIS)
    for name, desc in CLIS:
        print(f"  python -m satlas_sr_tpu_torch.{name:<{width}}  {desc}")
    print("\nThey run on the card and raise without one; infer, infer_grid, serve and "
          "export take --device cpu.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
