"""Device-stream ms of the program's `retrieve` span a traced request."""

from portbench import spans


def read(rec):
    return spans.per_request_stream_ms(rec, "retrieve")
