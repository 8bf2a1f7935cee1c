"""The whole extraction's share of the card's peak, in percent: the
faces embedded in the traced window times a face's operations (two
images' forward passes, counted from the configuration's shapes by
``work.face_flops``) over the window, against the peak of the
configuration's compute dtype."""

from port_bench import work
from port_bench.readers import flop_key, peak_share


def read(run):
    return peak_share(run, run.units * work.face_flops(run.cfg),
                      flop_key(run.cfg))
