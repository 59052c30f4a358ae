"""Slide tiling entry point of the port, with the root get_patches.py's
flags and output layout (the reference's get_patches.py CLI):

  python -m wsi_hgnn_tpu_torch.get_patches -d camelyon16 -m 0 -s 256 -b 40 -t 15 -j 32

Slides are `data/<dataset>/*/*.<slide_format>` and
`data/<dataset>/*/*/*.<slide_format>` under the working directory. One
magnification writes `data/patches/<dataset>/patches_lv0_ps256/<class>/
<slide>/<col>_<row>.<format>`; two write `WSI/<dataset>/pyramid/...`,
each low-magnification tile with a folder of its high-magnification
tiles. openslide reads .svs/.tif pyramids when it is installed; without
it any PIL-readable image is tiled as one full-resolution level. Host
work only: it needs no card.
"""
from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Patch extraction for WSI")
    parser.add_argument("-d", "--dataset", type=str, default="camelyon16")
    parser.add_argument("-e", "--overlap", type=int, default=0)
    parser.add_argument("-f", "--format", type=str, default="jpeg")
    parser.add_argument("-v", "--slide_format", type=str, default="tif")
    parser.add_argument("-j", "--workers", type=int, default=32)
    parser.add_argument("-q", "--quality", type=int, default=70)
    parser.add_argument("-s", "--tile_size", type=int, default=256)
    parser.add_argument("-b", "--base_mag", type=float, default=40)
    parser.add_argument("-m", "--magnifications", type=int, nargs="+",
                        default=(0,))
    parser.add_argument("-o", "--objective", type=float, default=20)
    parser.add_argument("-t", "--background_t", type=int, default=15)
    args = parser.parse_args(argv)

    levels = tuple(args.magnifications)
    if len(levels) > 2:
        parser.error("only 1 or 2 magnifications are supported")
    path_base = os.path.join("data", args.dataset)
    if len(levels) == 2:
        out_base = os.path.join("WSI", args.dataset, "pyramid")
    else:
        out_base = os.path.join("data", "patches", args.dataset,
                                "patches_lv0_ps256")
    all_slides = glob.glob(
        os.path.join(path_base, "*/*." + args.slide_format)) + glob.glob(
        os.path.join(path_base, "*/*/*." + args.slide_format))

    from .pipeline.tiler import tile_slides

    tile_slides(all_slides, out_base, levels=levels, base_mag=args.base_mag,
                objective=args.objective, fmt=args.format,
                tile_size=args.tile_size, overlap=args.overlap,
                quality=args.quality, workers=args.workers,
                background_t=args.background_t)
    return out_base


if __name__ == "__main__":
    main()
