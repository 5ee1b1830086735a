"""``flash.roofline_pct`` of the hook-driven cell, the mean over ranks; it
moves ``tokens_per_s.hooks``."""

from hvdbench.common import load_file

read = load_file("metrics", "flash.roofline_pct").read
