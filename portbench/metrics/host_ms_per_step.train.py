"""Host ms a training step in batch assembly (`sample_batch`), the
augmentation's draws and the copies to the card (`_to_device`): the driver
loop's own work, spans around its calls."""

from portbench import layers


def read(rec):
    spans = ("sample_batch", "draw_augment", "to_device")
    return layers.per_unit_ms(sum(rec["spans"].get(k, 0.0) for k in spans),
                              rec["span_calls"].get("sample_batch", 0))
