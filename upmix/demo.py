"""Demo/graphing entry point — parity with the reference's demo main
(center_extraction.py:645-736): run the full pipeline on a WAV with the
demo band edges [0, 40, 200, 2000], save the window/OA visualization for
band 0 and the time/spectrum comparison of Ls+C+Rs vs L+R.

Usage:
  python -m upmix.demo in.wav [--out-dir demo_out] [--band-edges ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from upmix.app import load_stereo, scale_lcr
from upmix.config import UpmixConfig
from upmix.models.offline import Upmixer
from upmix.ops.windows import design_wola_synthesis_window, make_window
from upmix.visualize import compare_upmix_vs_original, visualize_windows


def run_demo(in_path, out_dir="demo_out", band_edges=(0.0, 40.0, 200.0, 2000.0)):
    os.makedirs(out_dir, exist_ok=True)
    L, R, sr, peak_in = load_stereo(in_path)
    config = UpmixConfig.make(list(band_edges), sr=float(sr), verbose=True)

    # Window/OA visualization for the first band (ce.py:689-692).
    band0 = config.bands[0]
    aw = make_window(band0.window, band0.block_size)
    sw = design_wola_synthesis_window(aw, band0.overlap)
    win_png = os.path.join(out_dir, "windows_band0.png")
    visualize_windows(aw, sw, band0.overlap, save_path=win_png)

    C, Ls, Rs = Upmixer(config).process_np(
        L.astype(np.float32), R.astype(np.float32)
    )
    C, Ls, Rs, _ = scale_lcr(C, Ls, Rs, peak_in)

    cmp_png = os.path.join(out_dir, "upmix_vs_original.png")
    compare_upmix_vs_original(C, Ls, Rs, L, R, float(sr), save_path=cmp_png)
    print(win_png)
    print(cmp_png)
    return win_png, cmp_png


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="upmix.demo", description=__doc__)
    p.add_argument("input", help="input WAV file")
    p.add_argument("--out-dir", default="demo_out")
    p.add_argument("--band-edges", default="0,40,200,2000")
    args = p.parse_args(argv)
    edges = [float(x) for x in args.band_edges.split(",") if x.strip()]
    run_demo(args.input, out_dir=args.out_dir, band_edges=edges)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
