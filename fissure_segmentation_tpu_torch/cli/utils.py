"""Args persistence: commandline_args.json + test-time override merge.

Parity with reference cli/cli_utils.py:7-57 (store_args, load_args,
load_args_for_testing with override whitelist and forward-compat key fill).
A copy of the JAX package's cli/utils.py.
"""
from __future__ import annotations

import json
import os
from argparse import Namespace

TEST_TIME_OVERRIDES = ("test_only", "train_only", "show", "gpu", "fold",
                       "copd", "speed")


def store_args(args: Namespace, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "commandline_args.json"), "w") as f:
        json.dump(args.__dict__, f, indent=2)


def load_args_dict(from_dir: str):
    args_file = os.path.join(from_dir, "commandline_args.json")
    if not os.path.isfile(args_file):
        return None
    with open(args_file) as f:
        return json.load(f)


def load_args(from_dir: str) -> Namespace:
    return Namespace(**load_args_dict(from_dir))


def load_args_for_testing(from_dir: str, current_args: Namespace | None = None):
    args_from_file = load_args_dict(from_dir)
    if args_from_file is None and current_args is not None:
        store_args(current_args, from_dir)
        return current_args
    if args_from_file is None and current_args is None:
        raise RuntimeError("No args anywhere.")
    if args_from_file is not None and current_args is not None:
        for key in TEST_TIME_OVERRIDES:
            args_from_file[key] = getattr(current_args, key)
        # environment path, not a model hyperparameter: an explicitly passed
        # --data_dir wins at test time (e.g. COPD cases live elsewhere than
        # the training set); absent, the stored training path is kept
        if getattr(current_args, "data_dir", None) is not None:
            args_from_file["data_dir"] = current_args.data_dir
        for key in current_args.__dict__:
            if key not in args_from_file:
                args_from_file[key] = getattr(current_args, key)
    if args_from_file.get("copd"):
        args_from_file["test_only"] = True
    return Namespace(**args_from_file)
