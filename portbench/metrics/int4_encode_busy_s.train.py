"""Seconds a round the card is busy encoding the aggregate's payloads:
the union of the device operations put down to the program's
``agg.encode`` span (a codec's encode of a leaf; the int4 hash's int32
kernels) in the unfenced span rounds, their mean; absent where the codec
encodes nothing (f32)."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None else spans.busy_per_round("agg.encode")
