#!/usr/bin/env python
"""Console benchmark harness — the reference MainTest, on the device.

Mirrors VectorIndex.MainTest/Program.cs:

1. 10k x 1536 uniform random build, timed (Program.cs:9-31);
2. the crafted 1536 one-hot adversarial set — every dimension has
   identical statistics (Program.cs:34-67);
3. an ann-benchmarks HDF5 dataset (e.g. deep-image-96-angular): chunked
   ingest of /train, fused build, optional CSV export of the finished
   index as ``RangeID,Dimension,Mid,ID`` rows in the reference's heap
   numbering (Program.cs:70-156) — byte-compatible with the reference's
   export format so downstream SQL tooling can load either.

Usage:
  python benchmarks/main_test.py [hdf5_file] [index_csv_out]
"""

import os
import sys
import time

import numpy as np


def timed_build(name, vectors, leaf_size=1, export=None):
    from vector_database_tpu import build_index_fused

    t0 = time.time()
    index = build_index_fused(np.asarray(vectors, np.float32),
                              leaf_size=leaf_size)
    np.asarray(index.orig_row[:1])
    dt = time.time() - t0
    print(f"{name}: build {dt:.2f}s, nodes {index.num_nodes}, "
          f"depth {index.depth}, leaves {index.num_leaves}")
    if export:
        t0 = time.time()
        with open(export, "w") as f:
            f.write("RangeID,Dimension,Mid,ID\n")
            count = 0
            for heap, dim, mid, vid in index.heap_rows():
                f.write(f"{heap},{dim},{mid},{vid}\n")
                count += 1
                if count % 100000 == 0:
                    print(f"Processed {count} records.")
        print(f"{name}: exported {count} rows to {export} "
              f"({time.time() - t0:.1f}s)")
    return index


def main():
    from vector_database_tpu.utils import datasets

    # 1. random 10k x 1536 (Program.cs:9-31)
    timed_build(
        "random 10k x 1536",
        datasets.random_uniform(10_000, 1536, seed=int(time.time()) % 997),
    )

    # 2. crafted one-hot 1536 (Program.cs:34-67)
    timed_build("crafted one-hot 1536", datasets.one_hot_crafted(1536))

    # 3. HDF5 dataset (Program.cs:70-156)
    if len(sys.argv) > 1:
        path = sys.argv[1]
        export = sys.argv[2] if len(sys.argv) > 2 else None
        rows, dims = datasets.hdf5_size(path, "/train")
        print(f"{path}: /train {rows} x {dims}")
        parts = [c for _, c in datasets.load_hdf5(path, "/train")]
        train = np.concatenate(parts)
        timed_build(f"hdf5 {rows} x {dims}", train, leaf_size=16,
                    export=export)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
