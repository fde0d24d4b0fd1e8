"""Declarative flag/config system, the port's own copy of
``vit_torch_tpu/utils/args.py`` with the same flag surface.  ``--device``
is ``cuda`` (default) or ``cpu``.  Every flag of the JAX package's
surface works, the parallelism flags (``--mesh``, ``--fsdp``,
``--pipe_microbatches``) included.

Capability parity with the reference's ``ARGS`` class (reference:
``utils_args.py:3-128``): a config is a list of
``(keys, default, type[, choices[, help]])`` tuples; bools become
``store_true``/``store_false`` flags, list defaults become ``nargs='+'``,
choices are validated, and multiple aliases may be given for one flag.

Redesigned rather than copied: one pass builds the argparse parser and the
resolved dict; values are validated on every update; an explicit
``update(**overrides)`` supports programmatic use (tests, sweeps) without
any notebook-detection magic.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple


def time_stamp(t: Optional[float] = None) -> str:
    """``YYMMDD_HHMMSS`` stamp, same format the reference uses for stats paths."""
    return time.strftime("%y%m%d_%H%M%S", time.localtime(t))


class ARGS:
    """Declarative CLI config.

    Each config entry is ``(keys, default[, type[, choices[, help]]])`` where
    ``keys`` is a flag name or list of alias names.

    - ``A.args``: dict of resolved values (every alias maps to the value).
    - ``A.info``: dict keyed by the *primary* (first) alias only — this is what
      gets persisted into the stats JSON ``info`` section.
    - ``A.set_and_parse_args(argv=None)``: build argparse and parse; pass an
      explicit ``argv`` list for tests.
    - ``A.update(key=value, ...)``: programmatic override with validation.
    """

    def __init__(self, config: Sequence[Tuple] = ()):  # noqa: D107
        self._config: List[Tuple] = [tuple(v) for v in config]
        self.args: Dict[str, Any] = {}
        self.info: Dict[str, Any] = {}
        self._types: Dict[str, Optional[type]] = {}
        self._choices: Dict[str, Optional[list]] = {}
        self._primary: Dict[str, str] = {}  # alias -> primary key
        for entry in self._config:
            keys, default = self._keys_of(entry), entry[1]
            typ = entry[2] if len(entry) >= 3 else type(default)
            choices = entry[3] if len(entry) >= 4 else None
            for k in keys:
                self._types[k] = typ
                self._choices[k] = list(choices) if choices else None
                self._primary[k] = keys[0]
            self._set(keys[0], default)

    @staticmethod
    def _keys_of(entry: Tuple) -> List[str]:
        keys = entry[0]
        return list(keys) if isinstance(keys, (list, tuple)) else [keys]

    def _validate(self, key: str, value: Any) -> Any:
        typ = self._types.get(key)
        if typ is bool:
            value = bool(value)
        elif typ is not None and not isinstance(value, list) and value is not None:
            if not isinstance(value, typ):
                try:
                    value = typ(value)
                except (TypeError, ValueError):
                    raise AssertionError(
                        f"arg `{key}` must be of type <{typ.__name__}>, got {value!r}"
                    )
        choices = self._choices.get(key)
        if choices:
            assert value in choices, (
                f"arg `{key}` must be one of [{' | '.join(map(str, choices))}], got {value!r}"
            )
        return value

    def _set(self, key: str, value: Any) -> None:
        primary = self._primary.get(key, key)
        value = self._validate(primary, value)
        for alias, prim in self._primary.items():
            if prim == primary:
                self.args[alias] = value
        if primary not in self._primary.values():  # unknown key: plain set
            self.args[key] = value
        self.info[primary] = value

    def update(self, **overrides: Any) -> "ARGS":
        for k, v in overrides.items():
            self._set(k, v)
        return self

    def build_parser(self, name: str = "ARGS") -> argparse.ArgumentParser:
        parser = argparse.ArgumentParser(name)
        for entry in self._config:
            keys = self._keys_of(entry)
            default = self.args.get(keys[0], entry[1])
            typ = self._types[keys[0]]
            help_text = entry[4] if len(entry) >= 5 else None
            kwargs: Dict[str, Any] = {"default": default, "help": help_text}
            if typ is bool:
                # presence of the flag inverts the default, like the reference
                kwargs["action"] = "store_false" if default else "store_true"
            else:
                kwargs["type"] = typ
                if isinstance(default, list):
                    kwargs["nargs"] = "+"
                if self._choices[keys[0]]:
                    kwargs["choices"] = self._choices[keys[0]]
            parser.add_argument(*[f"--{k}" for k in keys], dest=keys[0], **kwargs)
        return parser

    def set_and_parse_args(self, argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
        parser = self.build_parser()
        ns = parser.parse_args(argv)
        for key, value in vars(ns).items():
            self._set(key, value)
        self.parsed_args = ns
        return ns


def classification_config(stamp: Optional[str] = None) -> List[Tuple]:
    """The reference ``main.py:73-101`` flag table, kept name-compatible.

    ``device`` is ``cuda`` (the default, as in the reference) or ``cpu``.
    """
    stamp = stamp or time_stamp()
    return [
        ("device", "cuda", str, ["cuda", "cpu"]),
        ("epoch", 100, int, None, "number of training epochs"),
        ("dataset", "stl10", str, None, "name of the dataset"),
        ("data_path", "./data", str, None, "path to the local image folder"),
        ("bs", 128, int, None, "batch size"),
        ("root_path", "./data", str, None,
         "path of the folder to put the pretrained models and download datasets"),
        ("arch", "swin_base_patch4_window7_224", str, None,
         "backbone network architecture"),
        ("lr", 0.001, float, None, "initial learning rate"),
        ("lr_scheduler", "step", str, ["none", "step", "exp", "cos", "ca", "cos_exp"],
         "type of lr scheduler"),
        ("lr_step", 10, int, None, "the number of epochs between each scheduling step"),
        ("lr_gamma", 0.5, float, None, "the rate of reducing for the learning rate"),
        ("lr_scale", 0.1, float, None, "the min scale ratio for some scheduler"),
        ("limit_train", 0, int, None, "set to int >0 to limit the number of training samples"),
        ("limit_test", 0, int, None, "set to int >0 to limit the number of testing samples"),
        ("stats_fp", f"./logs/massA/stats_{stamp}.json", str),
        ("lineareval", False, bool, None,
         "freeze the backbone, train only the classifier head (linear-eval protocol)"),
        ("earlystop_epoch", 5, int, None,
         "the number of epochs without improvement to stop the training process early"),
        ("pretrained", False, bool, None,
         "load pretrained weights for the arch (requires a local torch checkpoint)"),
        ("note", "", str, None, "note to recognize the run"),
        ("opt", "sgd", str, None, "set the optimizer"),
        ("fc", [], int, None, "the units for the additional fc layers"),
        ("image_size", 0, int, None,
         "size to resize the input image to, defaults to 0 meaning image is untouched"),
        ("tire_settings", 0, int, None,
         "settings [0-3] for tire dataset preprocessing"),
        ("aug_auto", "", str, ["", "imagenet", "cifar10", "stl10", "svhn"],
         "device-side AutoAugment policy ('' disables)"),
        # --- net-new (no reference equivalent): checkpointing / resume / precision ---
        ("ckpt_dir", "", str, None, "checkpoint directory ('' disables saving)"),
        ("export_bundle", "", str, None,
         "after training, export the classifier as a serving bundle "
         "(manifest + weights) to this directory"),
        ("export_bs", "1,8,32", str, None,
         "comma-separated batch-size buckets for --export_bundle"),
        ("resume", "", str, None, "checkpoint path to resume training from"),
        ("save_every", 0, int, None, "save a checkpoint every N epochs (0 = only best)"),
        ("dtype", "bfloat16", str, ["bfloat16", "float32"], "compute dtype"),
        ("seed", 0, int, None, "PRNG seed"),
        ("mesh", "", str, None,
         "mesh spec like 'data=8' or 'data=4,model=2' ('' = all devices on data)"),
        ("pipe_microbatches", 0, int, None,
         "GPipe microbatches per step under a pipe mesh axis (0 = one per "
         "stage; raise to amortize the fill/drain bubble)"),
        ("fsdp", False, bool, None,
         "ZeRO-3: shard params + optimizer moments over the data axis "
         "(per-step mesh path; implies --scan 0)"),
        ("torch_ckpt", "", str, None,
         "path to a torch state_dict checkpoint to import for --pretrained"),
        ("scan", 1, int, [0, 1],
         "epoch-scan mode: dataset device-resident, one dispatch per epoch "
         "(single-chip; multi-chip meshes use the per-step path)"),
        ("cache_features", False, bool, None,
         "lineareval: cache frozen backbone features once and train only "
         "the head (the reference's frozen-representation datasets)"),
    ]
