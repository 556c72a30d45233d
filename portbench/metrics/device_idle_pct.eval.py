"""Share of the traced serving window with nothing running on the card, in %."""

from portbench import layers


def read(rec):
    return layers.idle_pct(rec)
