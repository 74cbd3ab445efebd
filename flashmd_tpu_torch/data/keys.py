"""Names of the system fields that the checkpoints store (a copy of
flashmd_tpu/data/keys.py:12,31, so that the files of both packages use one
layout)."""

from typing import Final

POSITIONS_KEY: Final[str] = "pos"
VELOCITY_KEY: Final[str] = "velocities"
