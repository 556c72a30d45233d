"""Device ms a serving batch in copies: the batch in, the prediction out (and
memsets), from the profiler."""

from portbench import layers


def read(rec):
    return layers.per_unit_ms(sum(rec["trace"]["copies"].values()), rec["trace"]["units"])
