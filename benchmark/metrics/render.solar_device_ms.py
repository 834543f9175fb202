"""render.solar_device_ms: device time a view inside the port's
`render.solar` spans: the solar pass of every chunk (its field call along
the sun direction, the inputs included, and its composite), entry to exit
on the stream. The eval outputs drop what it computes."""

from benchmark import port_spans


def read(ctx):
    return port_spans.device_ms_per_unit(ctx, "render", "render.solar")
