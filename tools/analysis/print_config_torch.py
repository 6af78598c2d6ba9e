#!/usr/bin/env python
"""Print the fully-resolved config through the PyTorch port's config
loader (mirrors ``tools/analysis/print_config.py``).

    python tools/analysis/print_config_torch.py <config> [--cfg-options k=v ...]
"""

import argparse
import os
import pprint
import sys

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def main(argv=None):
    from adapt_image_models_torch.config.config import (
        Config, add_cfg_options_arg, apply_cfg_options,
    )
    p = argparse.ArgumentParser(description="Print a resolved config (PyTorch port)")
    p.add_argument("config")
    add_cfg_options_arg(p)
    args = p.parse_args(argv)
    cfg = apply_cfg_options(Config.fromfile(args.config), args.cfg_options)
    for k, v in cfg.to_dict().items():
        print(f"{k} = {pprint.pformat(v)}")


if __name__ == "__main__":
    main()
