"""Dataset generation CLI, port of `helmnet_tpu/cli/generate_dataset.py`
(reference generate_dataset.py). Host-only numpy: the same seed gives
the same maps and files as the JAX package's CLI.

    python -m helmnet_tpu_torch.cli.generate_dataset --num 11000 --imsize 96 \\
        --out datasets/splitted_96 --splits 9000 1000 1000
"""

import argparse

from ..data.ellipses import make_dataset, split_and_save


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num", type=int, default=11000)
    p.add_argument("--imsize", type=int, default=96)
    p.add_argument("--out", type=str, default="datasets/splitted_96")
    p.add_argument("--splits", type=int, nargs=3, default=(9000, 1000, 1000))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    print(f"Generating {args.num} ellipse sos maps at {args.imsize}^2 ...")
    maps = make_dataset(args.num, args.imsize, args.seed)
    out = split_and_save(maps, args.out, tuple(args.splits), args.seed)
    for name, path in out.items():
        print(f"  {name}: {path}")


if __name__ == "__main__":
    main()
