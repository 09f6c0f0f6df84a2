"""Convert a reference-schema hdf5 into the packed mmap runtime format
(counterpart of ``blt_vqg_tpu/cli/pack_dataset.py``, the same flags and
files).

    python -m blt_vqg_tpu_torch.cli.pack_dataset --input iq_dataset.hdf5 \
        --output data/packed/train

See data/packed.py: uint8 mmap images + token npz, served by the native
gather/surgery kernels (native/vqg_io.cc).
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--keep-float", action="store_true",
                        help="keep float32 images instead of uint8")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from blt_vqg_tpu_torch.data.packed import pack_hdf5
    out = pack_hdf5(args.input, args.output,
                    uint8_images=not args.keep_float)
    logging.info("packed %s -> %s", args.input, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
