"""``python -m repro_torch.analysis.lint`` — see cli.py for the flags."""
import sys

from .cli import main

sys.exit(main())
