"""The tool's consensus flags, read without the port's parser: ``-c``
thresholds, ``-m`` minimum depth, ``-f`` fill, ``-d`` maxdel (150 unless
given).  The port's route flags, which change no byte of the output, are
passed over."""

from __future__ import annotations

from typing import List

#: the port's flags that choose a route, not an output (each takes a value)
ROUTES = ("--pileup", "--wire", "--insertion-kernel", "--decoder",
          "--decode-threads")


def parse(flags: List[str]) -> dict:
    out = {"thresholds": [0.25], "min_depth": 1, "fill": "-", "maxdel": 150}
    it = iter(flags)
    for f in it:
        if f == "-c":
            out["thresholds"] = [float(t) for t in next(it).split(",")]
        elif f == "-m":
            out["min_depth"] = int(next(it))
        elif f == "-f":
            out["fill"] = next(it)
        elif f == "-d":
            out["maxdel"] = int(next(it))
        elif f in ROUTES:
            next(it)
        else:
            raise ValueError(f"flag {f!r} is not one the reference reads")
    return out
