"""The card's peak allocated memory over the training window, in GiB."""

from portbench import layers


def read(rec):
    return layers.peak_gib(rec)
