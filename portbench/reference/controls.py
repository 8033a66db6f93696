"""The controls: the reference put in the port's place with one of the
configuration's guarantees broken, to show that the comparison fails
them.  A cell's traffic file names its control.

* ``counts_float16``: counts held in half precision and raised one read
  at a time, as a narrowed K1 (an atomic add on ``half`` lanes, or the
  MXU product at half precision) would hold them: exact to 2,048 and
  stuck there, so every lane past it reads 2,048.  It breaks "every base
  counted exactly at any depth" only where a lane passes 2,048.
* ``insertions_dropped``: the insertion columns left out, as a pileup that
  skipped the insertion tail would write.  It breaks "insertions voted
  column by column" wherever a sample's insertion is called.
"""

CONTROLS = {
    "counts_float16": {"count_cap": 2048},
    "insertions_dropped": {"insertions": False},
}
