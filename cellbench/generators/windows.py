"""The BMI windows (``traffic.generator.Traffic``): every flush asks each
of the mix's windows once, with the mix's one aggregate, in the seed's
order."""

from __future__ import annotations

from cellbench.traffic.generator import Traffic


def make(mix: dict, seed: int, config: dict) -> Traffic:
    return Traffic(mix, seed, int(config["days"]))
