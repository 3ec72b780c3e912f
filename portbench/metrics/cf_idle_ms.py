"""Device-idle ms a traced request whose gaps fall inside the host's `cf` span."""

from portbench import spans


def read(rec):
    return spans.idle_inside_ms(rec, "cf")
