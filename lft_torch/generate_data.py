"""Data-generation CLI (counterpart of the root generate_data.py): the
Matlab-free replacement of the reference's Generate_Data_for_Training.m and
Generate_Data_for_Test.m.

    python -m lft_torch.generate_data --mode both --angRes 5 --scale_factor 4 \\
        --src ./datasets --dst_train ./data_for_train --dst_test ./data_for_test

Reads `<src>/<dataset>/{training,test}/*.mat` scenes holding `LF[U, V, H, W,
3+]` (classic or v7.3 .mat) and writes the h5 files the Matlab scripts
write, in their column-major layout.

    python -m lft_torch.generate_data --mode synth --dst .   # a synthetic set

Host code (numpy, scipy, h5py); it needs no card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="both", choices=["train", "test", "both", "synth"])
    ap.add_argument("--angRes", type=int, default=5)
    ap.add_argument("--scale_factor", type=int, default=4)
    ap.add_argument("--src", default="./datasets/")
    ap.add_argument("--dst_train", default="./data_for_train/")
    ap.add_argument("--dst_test", default="./data_for_test/")
    ap.add_argument("--dst", default=".", help="root for --mode synth")
    ap.add_argument("--datasets", nargs="*", default=None,
                    help="subset of dataset names (default: all)")
    ap.add_argument("--n_train", type=int, default=16, help="synth scenes")
    ap.add_argument("--n_test", type=int, default=2, help="synth scenes")
    ns = ap.parse_args(argv)

    if ns.mode == "synth":
        from lft_torch.data.synth import make_synth_data
        paths = make_synth_data(ns.dst, ang_res=ns.angRes, scale=ns.scale_factor,
                                n_train=ns.n_train, n_test=ns.n_test)
        print("synthetic dataset written:", paths)
        return

    from lft_torch.data.generate import generate_test_data, generate_training_data
    if ns.mode in ("train", "both"):
        n = generate_training_data(ns.src, ns.dst_train, ns.angRes, ns.scale_factor,
                                   datasets=ns.datasets)
        print(f"{n} training samples generated")
    if ns.mode in ("test", "both"):
        n = generate_test_data(ns.src, ns.dst_test, ns.angRes, ns.scale_factor,
                               datasets=ns.datasets)
        print(f"{n} test samples generated")


if __name__ == "__main__":
    main()
