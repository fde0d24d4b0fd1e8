"""Swin classification CLI twin, counterpart of
``vit_torch_tpu/cli/main_swin.py``: the main CLI with ``--arch`` defaulting
to a Swin config.

    python -m vit_torch_tpu_torch.cli.main_swin \\
        --arch swin_base_patch4_window12_384_22k --dataset synthetic \\
        --image_size 384 --bs 32 --epoch 1 --opt adamw --lr 1e-3 --fc 512 \\
        --lineareval [--cache_features]

On CUDA, Swin runs linear eval and eval only: fine-tuning needs the
window-attention backward kernel (ROADMAP.md B6) and raises before the
first step.  ``--device cpu`` fine-tunes through the plain versions.
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
