"""Host ms inside the train step's call: the eager step's launches (a span
around `make_train_step`'s step)."""

from portbench import layers


def read(rec):
    return layers.per_unit_ms(rec["spans"].get("train_step", 0.0),
                              rec["span_calls"].get("train_step", 0))
