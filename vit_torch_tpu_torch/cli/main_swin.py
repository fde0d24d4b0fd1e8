"""Swin classification CLI twin, counterpart of
``vit_torch_tpu/cli/main_swin.py``: the main CLI with ``--arch`` defaulting
to a Swin config.

    python -m vit_torch_tpu_torch.cli.main_swin \\
        --arch swin_base_patch4_window12_384_22k --dataset synthetic \\
        --image_size 384 --bs 32 --epoch 1 --opt adamw --lr 1e-4 --fc 512 \\
        [--lineareval [--cache_features]]

Without ``--lineareval`` every parameter trains.  On CUDA a fine-tune step
runs the window kernels forward (the whole-block kernel B9 for blocks whose
DropPath is inactive, PyTorch ops around the window-block kernel B8 for the
others) and their backward through the window-attention backward kernel
(B6); linear eval, cached linear eval and eval run the forward kernels
only.  ``--device cpu`` runs the same paths through the plain versions.
The parallelism flags (``--mesh``, ``--fsdp``, ``--pipe_microbatches``)
work as in ``cli.main``, which this entry point calls; under tensor
parallelism every block takes B8 over its rank's heads.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from vit_torch_tpu_torch.cli.main import main as _main
from vit_torch_tpu_torch.utils.stats import Stats


def main(argv: Optional[Sequence[str]] = None) -> Stats:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = ["--arch", "swin_base_patch4_window7_224"] + argv
    return _main(argv)


if __name__ == "__main__":
    main()
